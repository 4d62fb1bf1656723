"""The port's data layer: the tf.Example and TFRecord codecs, PIL-free PNG
decoding, the dataset registry, the converters, the host resize and the
device-side augmentation, and the input pipeline."""
