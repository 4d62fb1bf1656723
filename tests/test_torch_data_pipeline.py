"""The port's host data path against the JAX package's, on the CPU.

- ``host_resize_uint8``: equal to the JAX function (PIL's bilinear filter)
  to the byte in all six modes: shrinking 256 px to 4/8/16/64, enlarging
  16 to 64, non-square, gray and RGB inputs, the random crops with equal
  ``RandomState``s;
- every ``DATASETS`` decoder on records written by the JAX converters (or,
  where no converter writes a schema, by the JAX codec);
- ``TFRecordSource`` batches (float and ``yield_uint8``, over several
  epochs, through the cache and the contiguous arrays) and
  ``UnpairedSource`` batches equal the JAX ones for the same seed;
- ``DeviceResidentSampler`` on the CPU equals the JAX sampler and the
  streaming source;
- ``DevicePrefetcher`` keeps the order, filters the items, surfaces a
  worker's error and closes.
"""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from PIL import Image  # noqa: E402
from scipy.io import savemat  # noqa: E402

from twingan_tpu.data import converters as jconverters  # noqa: E402
from twingan_tpu.data import datasets as jdatasets  # noqa: E402
from twingan_tpu.data import pipeline as jpipeline  # noqa: E402
from twingan_tpu.data import preprocess as jpreprocess  # noqa: E402
from twingan_tpu.data.example import encode_example  # noqa: E402
from twingan_tpu.data.tfrecord import TFRecordWriter, list_shards  # noqa: E402

from twingan_tpu_torch.data import datasets, pipeline, preprocess  # noqa: E402


def rand_image(rng, h, w, c=3):
    return rng.randint(0, 256, (h, w, c)).astype(np.uint8)


# ---------------------------------------------------------------------- #
# host_resize_uint8

RESIZE_CASES = [
    ((256, 256, 3), "RESHAPE", 4), ((256, 256, 3), "RESHAPE", 8),
    ((256, 256, 3), "RESHAPE", 16), ((256, 256, 3), "RESHAPE", 64),
    ((16, 16, 3), "RESHAPE", 64), ((256, 256, 1), "RESHAPE", 8),
    ((40, 64, 3), "PAD", 32), ((64, 40, 3), "PAD", 16), ((320, 272, 3), "PAD", 256),
    ((31, 17), "PAD", 24), ((40, 64, 3), "CROP", 32), ((63, 40, 1), "CROP", 80),
    ((50, 30, 3), "RESHAPE", 64), ((17, 9, 3), "NONE", 32),
    ((64, 48, 3), "RANDOM_CROP", 32), ((20, 30, 3), "RANDOM_CROP", 24),
    ((64, 48, 3), "RANDOM_CROP_AND_RESHAPE", 16), ((30, 40, 1), "RANDOM_CROP_AND_RESHAPE", 20),
]


@pytest.mark.parametrize("shape,mode,hw", RESIZE_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{m}-{h}" for s, m, h in RESIZE_CASES])
def test_host_resize_is_bit_exact(shape, mode, hw):
    img = np.random.RandomState(hw).randint(0, 256, shape).astype(np.uint8)
    kw = {"initial_crop_hw": 36} if mode == "RANDOM_CROP_AND_RESHAPE" else {}
    for _ in range(2):  # the random modes draw again from the same streams
        ours_rng, theirs_rng = np.random.RandomState(7), np.random.RandomState(7)
        ours = preprocess.host_resize_uint8(img, mode, hw, rng=ours_rng, **kw)
        theirs = jpreprocess.host_resize_uint8(img, mode, hw, rng=theirs_rng, **kw)
        assert ours.dtype == np.uint8 and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(ours_rng.rand(3), theirs_rng.rand(3))
    np.testing.assert_array_equal(
        preprocess.host_resize(img, mode, hw, rng=np.random.RandomState(1), **kw),
        jpreprocess.host_resize(img, mode, hw, rng=np.random.RandomState(1), **kw))


def test_every_resize_mode_is_ported():
    assert set(preprocess.PORTED_RESIZE_MODES) == set(jpreprocess.RESIZE_MODES)
    with pytest.raises(ValueError, match="BOGUS"):
        preprocess.host_resize_uint8(np.zeros((4, 4, 3), np.uint8), "BOGUS", 8)


# ---------------------------------------------------------------------- #
# Datasets written by the JAX converters


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{dataset name: (shard dir, extra get_dataset kwargs)}."""
    root = tmp_path_factory.mktemp("records")
    rng = np.random.RandomState(0)
    imgs = root / "imgs"
    imgs.mkdir()
    for i in range(12):
        h, w = (24, 24) if i % 3 else (30, 20)
        fmt = "png" if i % 2 else "jpg"
        Image.fromarray(rand_image(rng, h, w)).save(str(imgs / f"img_{i:02d}.{fmt}"))
    out = {}
    jconverters.convert_image_folder(str(imgs), str(root / "image_only"), num_shards=3)
    out["image_only"] = (str(root / "image_only"), {})
    tags = root / "tags.tsv"
    tags.write_text("".join(f"img_{i:02d}.{'png' if i % 2 else 'jpg'}\tred,blue{i % 3}\n"
                            for i in range(10)))
    vocab = root / "vocab.txt"
    vocab.write_text("red\nblue0\nblue1\nblue2\n")
    for name in ("anime_faces", "danbooru_2_illust2vec"):
        jconverters.convert_tagged_images(str(imgs), str(tags), str(root / name),
                                          dataset_name=name, num_shards=2)
        out[name] = (str(root / name), {"vocab_file": str(vocab), "num_classes": 4})
    # anime_faces with numeric labels (no converter writes them).
    with TFRecordWriter(str(root / "labels" / "anime_faces_train_00000-of-00001.tfrecord")) as w:
        for i in range(6):
            img = Image.fromarray(rand_image(rng, 16, 16))
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            w.write(encode_example({"image/encoded": buf.getvalue(), "image/format": b"png",
                                    "image/class/label": np.asarray([i % 5, 7, -1], np.int64),
                                    "image/filename": f"l{i}".encode()}))
    out["anime_faces_labels"] = (str(root / "labels"), {"num_classes": 5})
    part = root / "partition.txt"
    part.write_text("".join(f"img_{i:02d}.{'png' if i % 2 else 'jpg'} {i % 2}\n"
                            for i in range(12)))
    attrs = root / "attrs.txt"
    attrs.write_text("12\nhdr\n" + "".join(
        f"img_{i:02d}.{'png' if i % 2 else 'jpg'} " + " ".join(
            str(1 if (i + k) % 3 else -1) for k in range(40)) + "\n" for i in range(12)))
    marks = root / "marks.txt"
    marks.write_text("12\nhdr\n" + "".join(
        f"img_{i:02d}.{'png' if i % 2 else 'jpg'} " + " ".join(
            str(i + k) for k in range(10)) + "\n" for i in range(12)))
    jconverters.convert_celeba(str(imgs), str(root / "celeba"), str(part), str(attrs),
                               str(marks), num_shards=2)
    out["celeba"] = (str(root / "celeba"), {})
    out["celeba_facenet"] = (str(root / "celeba"), {})
    src, tgt = root / "src", root / "tgt"
    src.mkdir()
    tgt.mkdir()
    for i in range(5):
        Image.fromarray(rand_image(rng, 20, 20)).save(str(src / f"p{i}.png"))
        Image.fromarray(rand_image(rng, 20, 20)).save(str(tgt / f"p{i}.png"))
    jconverters.convert_image_pairs(str(src), str(tgt), str(root / "image_pair"), num_shards=2)
    out["image_pair"] = (str(root / "image_pair"), {})
    savemat(str(root / "svhn.mat"), {"X": rng.randint(0, 256, (32, 32, 3, 7)).astype(np.uint8),
                                     "y": np.arange(1, 8).reshape(-1, 1)})
    jconverters.convert_svhn(str(root / "svhn.mat"), str(root / "svhn"))
    out["svhn"] = (str(root / "svhn"), {})
    return out


DECODER_CASES = ["image_only", "anime_faces", "anime_faces_labels", "danbooru_2_illust2vec",
                 "celeba", "celeba_facenet", "image_pair", "svhn"]


def same_item(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("case", DECODER_CASES)
@pytest.mark.parametrize("use_target", [False, True])
def test_decoders_agree_on_jax_records(records, case, use_target):
    shard_dir, kw = records[case]
    name = case.replace("_labels", "")
    ours = datasets.get_dataset(name, use_target=use_target, **kw)
    theirs = jdatasets.get_dataset(name, use_target=use_target, **kw)
    assert (ours.items_used, ours.items_need_preprocessing, ours.num_classes) == (
        theirs.items_used, theirs.items_need_preprocessing, theirs.num_classes)
    from twingan_tpu_torch.data.tfrecord import TFRecordReader

    n = 0
    for path in list_shards(shard_dir, "train"):
        for payload in TFRecordReader(path):
            same_item(ours.parse(payload), theirs.parse(payload))
            n += 1
    assert n > 0


def test_get_dataset_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.get_dataset("no_such_set")


# ---------------------------------------------------------------------- #
# Sources


def pp_pair(mode="PAD", hw=16, **kw):
    return (preprocess.PreprocessConfig(output_hw=hw, resize_mode=mode, **kw),
            jpreprocess.PreprocessConfig(output_hw=hw, resize_mode=mode, **kw))


def sources(records, name="image_only", batch=4, seed=3, mode="PAD", **kw):
    shard_dir, dkw = records[name]
    shards = list_shards(shard_dir, "train")
    ours_pp, theirs_pp = pp_pair(mode)
    return (pipeline.TFRecordSource(datasets.get_dataset(name, **dkw), shards, ours_pp, batch,
                                    seed=seed, **kw),
            jpipeline.TFRecordSource(jdatasets.get_dataset(name, **dkw), shards, theirs_pp,
                                     batch, seed=seed, **kw))


def take(source, n):
    it = iter(source)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(), dict(yield_uint8=True), dict(cache=False), dict(cache_max_bytes=2000),
    dict(mode="RANDOM_CROP"), dict(name="image_pair", yield_uint8=True),
    dict(name="celeba", batch=3),
], ids=["float", "uint8", "no-cache", "cache-cap", "random-crop", "pairs", "celeba"])
def test_tfrecord_source_batches_equal_jax(records, kw):
    ours, theirs = sources(records, **kw)
    assert ours.num_samples == theirs.num_samples
    for a, b in zip(take(ours, 10), take(theirs, 10)):  # several epochs
        same_item(a, b)
    assert (ours._arrays is None) == (theirs._arrays is None)


def test_tfrecord_source_one_epoch_without_drop(records):
    ours, theirs = sources(records, batch=5, repeat=False, drop_remainder=False)
    a, b = list(ours), list(theirs)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        same_item(x, y)


def test_tfrecord_source_errors(records, tmp_path):
    pp, _ = pp_pair()
    spec = datasets.get_dataset("image_only")
    with pytest.raises(ValueError, match="no tfrecord shards"):
        pipeline.TFRecordSource(spec, [], pp, 2)
    empty = tmp_path / "image_only_train_00000-of-00001.tfrecord"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        pipeline.TFRecordSource(spec, [str(empty)], pp, 2)
    shards = list_shards(records["image_only"][0], "train")
    with pytest.raises(ValueError, match="no batch"):
        pipeline.TFRecordSource(spec, shards, pp, 100)
    wrong = pipeline.TFRecordSource(datasets.get_dataset("image_pair"), shards, pp, 2)
    with pytest.raises(RuntimeError, match="every record failed"):
        next(iter(wrong))


def test_materialize_matches_jax(records):
    ours, theirs = sources(records, yield_uint8=True)
    a, b = ours.materialize(1 << 20), theirs.materialize(1 << 20)
    same_item(a, b)
    ours, theirs = sources(records)
    assert ours.materialize(100) is None and theirs.materialize(100) is None
    ours, theirs = sources(records, mode="RANDOM_CROP")
    assert ours.materialize() is None and theirs.materialize() is None


def test_unpaired_source_batches_equal_jax(records):
    a1, a2 = sources(records, seed=1)
    b1, b2 = sources(records, name="image_pair", seed=2)
    for x, y in zip(take(pipeline.UnpairedSource(a1, b1), 6),
                    take(jpipeline.UnpairedSource(a2, b2), 6)):
        same_item(x, y)


def resident_domains(records, package):
    out = []
    for name, key_map, seed in (
            ("image_only", {"source": "source", "conditional_labels": "conditional_labels"}, 5),
            ("image_pair", {"target": "target", "target_embedding": "embedding"}, 6)):
        ours, theirs = sources(records, name=name, yield_uint8=True)
        src = ours if package == "port" else theirs
        out.append((src.materialize(1 << 24), key_map, seed))
    return out


def test_device_resident_sampler_equals_jax_and_streaming(records):
    ours = pipeline.DeviceResidentSampler(resident_domains(records, "port"), 4, "cpu")
    theirs = jpipeline.DeviceResidentSampler(resident_domains(records, "jax"), 4)
    assert ours.resident_bytes == theirs.resident_bytes
    for n_rounds, n_critic in ((2, 2), (1, 3), (3, 1), (2, 2)):
        a = ours.sample_chunk(n_rounds, n_critic)
        b = theirs.sample_chunk(n_rounds, n_critic)
        assert ours.last_index_bytes == theirs.last_index_bytes
        assert set(a) == set(b) == {"source", "target"}
        for k in a:
            assert a[k].device.type == "cpu" and a[k].dtype == torch.uint8
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    batches = ours.sample_batches(2)
    assert len(batches) == 2 and batches[0]["source"].shape == (4, 16, 16, 3)
    # The same sequence as the streaming source over built arrays.
    stream, _ = sources(records, yield_uint8=True, seed=9)
    stream.materialize(1 << 24)
    resident = pipeline.DeviceResidentSampler(
        [(stream.materialize(1 << 24), {"target": "source"}, 9)], 4, "cpu")
    for batch in take(stream, 7):
        np.testing.assert_array_equal(resident.sample_batches(1)[0]["target"].numpy(),
                                      batch["source"])


def test_device_resident_sampler_errors():
    arrays = {"source": np.zeros((3, 2, 2, 3), np.uint8), "x": np.zeros((4,), np.float32)}
    with pytest.raises(ValueError, match="disagree"):
        pipeline.DeviceResidentSampler([(arrays, {"a": "source", "b": "x"}, 0)], 2, "cpu")
    with pytest.raises(ValueError, match="no batch"):
        pipeline.DeviceResidentSampler([(arrays, {"a": "source"}, 0)], 4, "cpu")
    with pytest.raises(ValueError, match="no usable"):
        pipeline.DeviceResidentSampler([(arrays, {"a": "missing"}, 0)], 2, "cpu")


def test_device_prefetcher_keeps_order_and_closes():
    items = [{"x": np.full((2, 3), i, np.float32), "name": np.asarray([b"a", b"b"]),
              "y": np.arange(2) + i} for i in range(7)]
    pf = pipeline.DevicePrefetcher(iter(items), depth=2, device="cpu")
    got = list(pf)
    assert len(got) == 7
    for i, batch in enumerate(got):
        assert set(batch) == {"x", "y"}  # string items dropped
        assert isinstance(batch["x"], torch.Tensor) and float(batch["x"][0, 0]) == i
    pf.close()
    pf = pipeline.DevicePrefetcher(iter(items), device="cpu", keys=("y", "missing"),
                                   to_device=False)
    first = next(pf)
    assert set(first) == {"y"} and isinstance(first["y"], np.ndarray)
    pf.close()  # mid-stream
    assert not pf._thread.is_alive()

    def failing():
        yield items[0]
        raise OSError("disk gone")

    pf = pipeline.DevicePrefetcher(failing(), device="cpu")
    next(pf)
    with pytest.raises(RuntimeError, match="worker failed"):
        next(pf)
    pf.close()


def test_device_prefetcher_on_a_cuda_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.DevicePrefetcher(iter([]), device="cuda")


def test_synthetic_source_unchanged():
    a = pipeline.SyntheticSource(2, 8, seed=4, keys=("target", "conditional_labels"),
                                 num_classes=3)
    b = jpipeline.SyntheticSource(2, 8, seed=4, keys=("target", "conditional_labels"),
                                  num_classes=3)
    for x, y in zip(take(a, 3), take(b, 3)):
        same_item(x, y)
    assert jax.default_backend() == "cpu"
    assert os.path.basename(pipeline.__file__) == "pipeline.py"
