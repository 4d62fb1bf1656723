"""Preprocessing factory: per-model train and eval preprocessing.

Counterpart of ``twingan_tpu/data/preprocessing_factory.py``. Each entry
builds a batched function of float [0, 1] NHWC images at ``output_hw``:

- danbooru:  the GAN path (``data/preprocess.augment_batch``);
- inception: central crop 0.875 (eval), or a random 0.8 crop, resize, flip
             and colour distortion (train); scaled to [-1, 1];
- vgg:       resize to ``resize_side`` (1.145 x by default) and a central
             (eval) or random flipped (train) crop, x255, RGB means
             subtracted;
- cifarnet:  zero padding, random crop and flip (train), then per-image
             standardization;
- lenet:     grayscale and linear scaling to [-1, 1].

The JAX functions take a PRNG key. Here each is a ``Preprocessing`` whose
training mode is split in two: ``draw`` takes the random numbers (crop
offsets, flips, the colour ordering and its factors, as ``AugmentDraws``)
from a ``torch.Generator``, and ``apply`` is the deterministic rest; a
call does both, or takes injected ``draws``. Crops and the colour
distortion are ``data/preprocess.py``'s; every resize is
``jax.image.resize``'s bilinear (antialiased where it shrinks).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from twingan_tpu_torch.data.preprocess import (
    COLOR_RANGES,
    MEAN_IMAGE_SUBTRACTION_RGB,
    ORDERINGS,
    AugmentDraws,
    PreprocessConfig,
    augment_batch,
    distort_color,
    draw_augmentation,
    postprocess_image,
    resize_bilinear,
)

VGG_MEANS_RGB = MEAN_IMAGE_SUBTRACTION_RGB
INCEPTION_CROP = 0.8


def _central_crop(x: torch.Tensor, fraction: float) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    ch, cw = int(h * fraction), int(w * fraction)
    oy, ox = (h - ch) // 2, (w - cw) // 2
    return x[:, oy: oy + ch, ox: ox + cw, :]


def _random_crop(x: torch.Tensor, draws: AugmentDraws, out_hw: int) -> torch.Tensor:
    return torch.stack([img[y: y + out_hw, xo: xo + out_hw] for img, y, xo in
                        zip(x, draws.crop_y.tolist(), draws.crop_x.tolist())])


def _flip(x: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    return torch.where(draws.flip.to(x.device).view(-1, 1, 1, 1), x.flip(2), x)


def _draw_crop_flip(b: int, span: int, generator: torch.Generator) -> AugmentDraws:
    dev = generator.device
    ys = torch.randint(0, span, (b,), generator=generator, device=dev)
    xs = torch.randint(0, span, (b,), generator=generator, device=dev)
    flip = torch.rand((b,), generator=generator, device=dev) < 0.5
    return AugmentDraws(ys, xs, flip)


class Preprocessing:
    """``fn(images, generator=None, draws=None)``; in training mode the
    random numbers come from ``draws``, else from ``generator``."""

    is_training = False

    def draw(self, shape, generator: torch.Generator) -> Optional[AugmentDraws]:
        return None

    def apply(self, images: torch.Tensor, draws: Optional[AugmentDraws]) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                 draws: Optional[AugmentDraws] = None) -> torch.Tensor:
        x = images.float()
        if self.is_training and draws is None:
            if generator is None:
                raise ValueError("training-mode preprocessing needs a generator or draws")
            draws = self.draw(x.shape, generator)
        return self.apply(x, draws)


class danbooru(Preprocessing):  # noqa: N801 - the factory's names
    def __init__(self, output_hw: int, is_training: bool = False, **kw):
        self.cfg = PreprocessConfig(output_hw=output_hw, is_training=is_training, **kw)
        self.is_training = is_training

    def draw(self, shape, generator):
        return draw_augmentation(self.cfg, shape, generator)

    def apply(self, images, draws):
        return augment_batch(images, self.cfg, draws=draws)


class inception(Preprocessing):  # noqa: N801
    def __init__(self, output_hw: int, is_training: bool = False, fast_mode: bool = True):
        self.output_hw, self.is_training, self.fast_mode = output_hw, is_training, fast_mode

    def draw(self, shape, generator):
        b, h = shape[0], shape[1]
        crop_hw = max(1, int(h * INCEPTION_CROP))
        draws = _draw_crop_flip(b, h - crop_hw + 1, generator)
        dev = generator.device
        draws.ordering = int(torch.randint(0, 2 if self.fast_mode else 4, (),
                                           generator=generator, device=dev))
        draws.color = tuple(
            torch.empty(b, device=dev).uniform_(*COLOR_RANGES[op], generator=generator)
            for op in ORDERINGS[self.fast_mode][draws.ordering])
        return draws

    def apply(self, images, draws):
        x = images
        if self.is_training:
            x = _random_crop(x, draws, max(1, int(x.shape[1] * INCEPTION_CROP)))
            x = _flip(resize_bilinear(x, self.output_hw), draws)
            x = distort_color(x, draws.ordering, [f.to(x.device) for f in draws.color],
                              self.fast_mode)
        else:
            x = resize_bilinear(_central_crop(x, 0.875), self.output_hw)
        return x * 2.0 - 1.0


class vgg(Preprocessing):  # noqa: N801
    def __init__(self, output_hw: int, is_training: bool = False, resize_side: int = 0):
        self.output_hw, self.is_training = output_hw, is_training
        self.side = resize_side or int(output_hw * 1.145)

    def draw(self, shape, generator):
        return _draw_crop_flip(shape[0], self.side - self.output_hw + 1, generator)

    def apply(self, images, draws):
        x = resize_bilinear(images * 255.0, self.side)
        out = self.output_hw
        if self.is_training:
            x = _flip(_random_crop(x, draws, out), draws)
        else:
            oy = (self.side - out) // 2
            x = x[:, oy: oy + out, oy: oy + out, :]
        return x - x.new_tensor(VGG_MEANS_RGB)


class cifarnet(Preprocessing):  # noqa: N801
    def __init__(self, output_hw: int = 32, is_training: bool = False, padding: int = 4):
        self.output_hw, self.is_training, self.padding = output_hw, is_training, padding

    def draw(self, shape, generator):
        return _draw_crop_flip(shape[0], shape[1] + 2 * self.padding - self.output_hw + 1,
                               generator)

    def apply(self, images, draws):
        x = images
        if self.is_training:
            p = self.padding
            x = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
            x = _flip(_random_crop(x, draws, self.output_hw), draws)
        elif x.shape[1] != self.output_hw:
            x = resize_bilinear(x, self.output_hw)
        # Per-image standardization (tf.image.per_image_standardization).
        mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
        std = torch.sqrt(torch.mean(torch.square(x - mean), dim=(1, 2, 3), keepdim=True))
        n = x.shape[1] * x.shape[2] * x.shape[3]
        return (x - mean) / torch.clamp(std, min=1.0 / float(n) ** 0.5)


class lenet(Preprocessing):  # noqa: N801
    def __init__(self, output_hw: int = 28, is_training: bool = False):
        self.output_hw, self.is_training = output_hw, False

    def apply(self, images, draws):
        x = images
        if x.shape[-1] == 3:
            x = torch.mean(x * x.new_tensor([0.299, 0.587, 0.114]), dim=-1, keepdim=True)
        if x.shape[1] != self.output_hw:
            x = resize_bilinear(x, self.output_hw)
        return x * 2.0 - 1.0


PREPROCESSORS = {
    "danbooru": danbooru,
    "inception": inception,
    "inception_v1": inception,
    "inception_v3": inception,
    "vgg": vgg,
    "vgg_16": vgg,
    "vgg_19": vgg,
    "vgg_a": vgg,
    "illust2vec": danbooru,
    "cifarnet": cifarnet,
    "lenet": lenet,
}

POSTPROCESSORS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "danbooru": lambda x: postprocess_image(x, "rgb"),
    "inception": lambda x: torch.clamp((x + 1.0) / 2.0, 0.0, 1.0),
    "vgg": lambda x: torch.clamp((x + x.new_tensor(VGG_MEANS_RGB)) / 255.0, 0.0, 1.0),
}


def get_preprocessing(name: str, output_hw: int, is_training: bool = False,
                      **kw) -> Preprocessing:
    if name not in PREPROCESSORS:
        raise ValueError(f"unknown preprocessing {name!r}; known: {sorted(PREPROCESSORS)}")
    return PREPROCESSORS[name](output_hw, is_training=is_training, **kw)


def get_postprocessing(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return POSTPROCESSORS.get(name, POSTPROCESSORS["danbooru"])
