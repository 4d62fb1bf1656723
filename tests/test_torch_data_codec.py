"""The port's record codecs against the JAX package's, and its PIL-free PNG
decoder against PIL.

- tf.Example: both packages encode the same features to the same bytes and
  decode each other's bytes to the same values;
- TFRecord: files written by either package are byte-identical and read
  back by the other, with and without CRC verification, on the native and
  the pure-Python scan;
- crc32c: the native and pure-Python paths agree with each other and with
  the JAX package's;
- ``decode_png`` equals ``PIL.Image.open(...).convert("RGB")`` on
  PIL-written files of every mode it supports (gray, gray + alpha, RGB,
  RGBA, palette at 8 bits and below, 1-bit), at odd sizes, with random and
  smooth content, and on files written here with the five row filters
  cycled row by row (PIL's encoder never picks some of them); the fixtures
  are checked to cover all five filters, and the native unfilter equals the
  numpy one on every fixture.
"""

import io
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from twingan_tpu.data import example as jexample  # noqa: E402
from twingan_tpu.data import tfrecord as jtfrecord  # noqa: E402

from twingan_tpu_torch import native  # noqa: E402
from twingan_tpu_torch.data import datasets, example, png, tfrecord  # noqa: E402

FEATURES = [
    {"image/encoded": b"\x00\x01binary\xff", "image/format": b"png",
     "image/filename": "a_file.png"},
    {"image/class/label": np.asarray([3, -1, 2 ** 40], np.int64),
     "image/landmarks": np.asarray([0.5, -1.25, 3e7], np.float32),
     "image/class/text": "tag1,tag2", "image/attribs": np.asarray([1, 0, 1], np.int64)},
    {"image/encoded_source": [b"x" * 300, b""], "empty_floats": np.zeros(0, np.float32),
     "flags": np.asarray([True, False])},
]


def same_values(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("features", FEATURES)
def test_example_encode_and_decode_agree(features):
    ours, theirs = example.encode_example(features), jexample.encode_example(features)
    assert ours == theirs
    same_values(example.decode_example(theirs), jexample.decode_example(ours))
    same_values(example.decode_example(ours), jexample.decode_example(theirs))


PAYLOADS = [b"", b"a", bytes(range(256)) * 5, example.encode_example(FEATURES[0])]


@pytest.fixture(params=["native", "python"])
def scan_path(request, monkeypatch):
    """Each reader test runs on the native scan and on the pure-Python one."""
    if request.param == "python":
        monkeypatch.setattr(native, "load", lambda: None)
    else:
        assert native.load() is not None  # g++ is here: the library builds
    return request.param


@pytest.mark.parametrize("verify", [False, True])
def test_tfrecord_files_are_identical_and_cross_read(tmp_path, scan_path, verify):
    ours, theirs = str(tmp_path / "ours.tfrecord"), str(tmp_path / "theirs.tfrecord")
    with tfrecord.TFRecordWriter(ours) as w:
        for p in PAYLOADS:
            w.write(p)
    with jtfrecord.TFRecordWriter(theirs) as w:
        for p in PAYLOADS:
            w.write(p)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for reader in (tfrecord.TFRecordReader(theirs, verify=verify),
                   jtfrecord.TFRecordReader(ours, verify=verify)):
        assert [bytes(r) for r in reader] == PAYLOADS
        reader.close()


def test_tfrecord_corruption_and_truncation_raise(tmp_path, scan_path):
    path = str(tmp_path / "x.tfrecord")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"payload-one")
        w.write(b"payload-two")
    data = bytearray(open(path, "rb").read())
    corrupt = str(tmp_path / "corrupt.tfrecord")
    data[14] ^= 0xFF  # a payload byte of the first record
    open(corrupt, "wb").write(bytes(data))
    assert len(tfrecord.TFRecordReader(corrupt)) == 2  # framing alone is intact
    with pytest.raises(IOError, match="corrupt"):
        tfrecord.TFRecordReader(corrupt, verify=True)
    truncated = str(tmp_path / "truncated.tfrecord")
    open(truncated, "wb").write(open(path, "rb").read()[:-6])
    with pytest.raises(IOError):
        tfrecord.TFRecordReader(truncated)


def test_list_shards_matches_jax(tmp_path):
    for name in ("faces_train_00000-of-00002.tfrecord", "faces_train_00001-of-00002.tfrecord",
                 "faces_validation_00000-of-00001.tfrecord", "pretrain_faces_x.tfrecord",
                 "faces_train_00002.tfrecord.tmp", "train.tfrecord"):
        (tmp_path / name).write_bytes(b"")
    for split in ("train", "validation", "faces"):
        assert tfrecord.list_shards(str(tmp_path), split) == jtfrecord.list_shards(
            str(tmp_path), split)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 1000])
def test_crc32c_native_python_and_jax_agree(monkeypatch, n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8).tobytes()
    fast = tfrecord.crc32c(data)
    masked = tfrecord.masked_crc32c(data)
    monkeypatch.setattr(native, "load", lambda: None)
    assert tfrecord.crc32c(data) == fast == jtfrecord.crc32c(data)
    assert tfrecord.masked_crc32c(data) == masked == jtfrecord.masked_crc32c(data)
    if n == 9:
        assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# ---------------------------------------------------------------------- #
# PNG


def smooth(rng, h, w, c):
    """A smooth random field: bilinear-upsampled noise, so rows are
    predictable and the encoder picks the predicting filters."""
    coarse = rng.rand(h // 6 + 2, w // 6 + 2, c)
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    field = ((1 - fy) * (1 - fx) * coarse[y0][:, x0] + fy * (1 - fx) * coarse[y0 + 1][:, x0]
             + (1 - fy) * fx * coarse[y0][:, x0 + 1] + fy * fx * coarse[y0 + 1][:, x0 + 1])
    return (field * 255).astype(np.uint8)


def pil_png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def cycled_png(arr: np.ndarray, color_type: int, interlace: int = 0, depth: int = 8) -> bytes:
    """An 8-bit PNG whose rows take the filter types 0-4 in turn."""
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).astype(np.int64)
    bpp = arr.shape[2] if arr.ndim == 3 else 1
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for r in range(h):
        kind, cur = r % 5, rows[r]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            pred = np.array([png._paeth(int(a), int(b), int(c))
                             for a, b, c in zip(left, prev, upleft)], np.int64)
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


def pil_fixtures():
    rng = np.random.RandomState(0)
    out = []
    for mode, c in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        for h, w in ((17, 23), (40, 9)):
            for content in ("random", "smooth"):
                arr = (rng.randint(0, 256, (h, w, c)).astype(np.uint8) if content == "random"
                       else smooth(rng, h, w, c))
                out.append((f"{mode}-{h}x{w}-{content}",
                            pil_png(Image.fromarray(arr[..., 0] if c == 1 else arr, mode))))
    for colors in (200, 12, 3):
        for content in ("random", "smooth"):
            arr = (rng.randint(0, 256, (31, 29, 3)).astype(np.uint8) if content == "random"
                   else smooth(rng, 31, 29, 3))
            img = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=colors)
            out.append((f"P{colors}-{content}", pil_png(img)))
    out.append(("1-bit", pil_png(Image.fromarray(smooth(rng, 19, 21, 1)[..., 0]).convert("1"))))
    return out


def cycled_fixtures():
    rng = np.random.RandomState(1)
    return [(f"cycled-{name}", cycled_png(arr, ct)) for name, arr, ct in (
        ("gray", smooth(rng, 23, 15, 1)[..., 0], 0),
        ("rgb", smooth(rng, 21, 33, 3), 2),
        ("rgba-random", rng.randint(0, 256, (12, 7, 4)).astype(np.uint8), 6),
        ("gray-alpha", smooth(rng, 10, 11, 2), 4),
    )]


FIXTURES = pil_fixtures() + cycled_fixtures()


@pytest.mark.parametrize("name,data", FIXTURES, ids=[n for n, _ in FIXTURES])
def test_decode_png_equals_pil(name, data):
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)
    out = png.decode_png(data)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(datasets._decode_image(data, b"png"), ref)


def test_fixtures_cover_every_filter_and_mode():
    filters = set()
    kinds = set()
    for _, data in FIXTURES:
        filters |= set(png.row_filters(data))
        info = png.read_header(data)
        kinds.add((info["color_type"], info["depth"]))
    assert filters == {0, 1, 2, 3, 4}
    assert {(0, 8), (4, 8), (2, 8), (6, 8), (3, 8), (0, 1)} <= kinds
    assert kinds & {(3, 1), (3, 2), (3, 4)}


@pytest.mark.parametrize("name,data", FIXTURES, ids=[n for n, _ in FIXTURES])
def test_native_unfilter_equals_numpy(name, data):
    assert native.load() is not None
    info = png.read_header(data)
    channels = png.CHANNELS[info["color_type"]]
    stride = (info["width"] * channels * info["depth"] + 7) // 8
    bpp = max(1, channels * info["depth"] // 8)
    raw = zlib.decompress(info["idat"])
    np.testing.assert_array_equal(
        png.unfilter(raw, info["height"], stride, bpp),
        png.unfilter_numpy(np.frombuffer(raw, np.uint8), info["height"], stride, bpp))


def test_unsupported_pngs_raise():
    arr = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(cycled_png(arr, 2, interlace=1))
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(buf, format="PNG")
    assert png.read_header(buf.getvalue())["depth"] == 16
    with pytest.raises(ValueError, match="16-bit"):
        png.decode_png(buf.getvalue())
    bad = bytearray(pil_png(Image.fromarray(arr)))
    bad[-20] ^= 0xFF  # inside IDAT: its CRC fails
    with pytest.raises(ValueError):
        png.decode_png(bytes(bad))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(20))


def test_jpeg_without_pil_raises_and_says_why(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    assert datasets._decode_image(buf.getvalue(), b"jpeg").shape == (8, 8, 3)
    png_bytes = pil_png(Image.fromarray(np.zeros((3, 5, 3), np.uint8)))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        datasets._decode_image(buf.getvalue(), b"jpeg")
    assert datasets._decode_image(png_bytes, b"png").shape == (3, 5, 3)  # PNG still decodes
