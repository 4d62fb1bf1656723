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
  PIL-written files (gray, gray + alpha, RGB, RGBA, palette at 8 bits and
  below, 1-bit, 16-bit gray), at odd sizes, with random and smooth
  content, and on files written here with the five row filters cycled row
  by row (PIL's encoder never picks some of them, and writes neither
  interlaced files nor 16-bit colour): every colour type at every depth
  PNG allows, plain and Adam7-interlaced (passes partly empty at the small
  sizes); the fixtures are checked to cover all five filters and every
  kind, invalid headers raise, and the native unfilter equals the numpy
  one on every non-interlaced fixture.
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


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[H, W, C] samples -> [H, stride] uint8 scanlines (big-endian at 16
    bits; below 8 bits packed most significant first, rows byte-padded)."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples.reshape(h, -1, 1).astype(np.uint8)
            >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(rows: np.ndarray, bpp: int, first_kind: int) -> bytes:
    """Scanlines filtered with the types 0-4 in turn, from ``first_kind``."""
    rows = rows.astype(np.int64)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for r in range(rows.shape[0]):
        kind, cur = (first_kind + r) % 5, rows[r]
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
    return bytes(out)


def cycled_png(arr: np.ndarray, color_type: int, interlace: int = 0, depth: int = 8,
               palette=None) -> bytes:
    """A PNG of the samples ``arr`` ([H, W] or [H, W, C]; uint16 at 16
    bits) whose rows take the filter types 0-4 in turn; interlaced, each
    Adam7 pass is filtered as an image of its own, the types running on
    from the pass before."""
    samples = arr.reshape(arr.shape[0], arr.shape[1], -1)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        idat, kind = b"", 0
        for x0, y0, dx, dy in png.ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                idat += _filtered(_pack(sub, depth), bpp, kind)
                kind += sub.shape[0]
    else:
        idat = _filtered(_pack(samples, depth), bpp, 0)
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    plte = b"" if palette is None else _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (png.SIGNATURE + _chunk(b"IHDR", header) + plte
            + _chunk(b"IDAT", zlib.compress(idat)) + _chunk(b"IEND", b""))


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


def wide_fixtures():
    """16-bit files of every kind that has them, and interlaced files of
    every kind and depth, at sizes whose Adam7 passes are partly empty."""
    rng = np.random.RandomState(2)
    out = []
    for name, ct, c in (("gray", 0, 1), ("gray-alpha", 4, 2), ("rgb", 2, 3), ("rgba", 6, 4)):
        for content in ("random", "low"):
            # "low": gray values under 256 too, where PIL's I;16 clip shows.
            high = 1 << 16 if content == "random" else 300
            arr = rng.randint(0, high, (13, 11, c)).astype(np.uint16)
            out.append((f"16bit-{name}-{content}", cycled_png(arr, ct, depth=16)))
            out.append((f"16bit-{name}-{content}-adam7", cycled_png(arr, ct, 1, depth=16)))
    kinds = [("gray", 0, 1, d) for d in (1, 2, 4, 8)] + [
        ("gray-alpha", 4, 2, 8), ("rgb", 2, 3, 8), ("rgba", 6, 4, 8)] + [
        ("palette", 3, 1, d) for d in (1, 2, 4, 8)]
    for name, ct, c, depth in kinds:
        for h, w in ((1, 1), (3, 2), (9, 5), (17, 23)):
            arr = rng.randint(0, 1 << depth, (h, w, c)).astype(np.uint8)
            # A palette shorter than the depth allows: PIL's gray ramp fills it.
            palette = rng.randint(0, 256, (max(1, (1 << depth) - 3), 3)) if ct == 3 else None
            out.append((f"adam7-{name}{depth}-{h}x{w}", cycled_png(arr, ct, 1, depth, palette)))
        out.append((f"plain-{name}{depth}", cycled_png(arr, ct, 0, depth, palette)))
    # PIL writes 16-bit gray itself (mode I;16).
    out.append(("16bit-gray-pil", pil_png(Image.fromarray(
        rng.randint(0, 1 << 16, (9, 14)).astype(np.uint16)))))
    return out


FIXTURES = pil_fixtures() + cycled_fixtures() + wide_fixtures()


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
    # Every kind and depth PNG allows, plain and interlaced.
    valid = ({(0, d) for d in (1, 2, 4, 8, 16)} | {(3, d) for d in (1, 2, 4, 8)}
             | {(ct, d) for ct in (2, 4, 6) for d in (8, 16)})
    for interlace in (0, 1):
        seen = set()
        for _, data in FIXTURES:
            info = png.read_header(data)
            if info["interlace"] == interlace:
                seen.add((info["color_type"], info["depth"]))
        assert seen == valid, (interlace, valid - seen)


@pytest.mark.parametrize("name,data", FIXTURES, ids=[n for n, _ in FIXTURES])
def test_native_unfilter_equals_numpy(name, data):
    assert native.load() is not None
    info = png.read_header(data)
    channels = png.CHANNELS[info["color_type"]]
    bpp = max(1, channels * info["depth"] // 8)
    raw = zlib.decompress(info["idat"])
    pos = 0
    for *_, pw, ph in png.passes(info):
        stride = (pw * channels * info["depth"] + 7) // 8
        part = raw[pos: pos + ph * (stride + 1)]
        np.testing.assert_array_equal(
            png.unfilter(part, ph, stride, bpp),
            png.unfilter_numpy(np.frombuffer(part, np.uint8), ph, stride, bpp))
        pos += ph * (stride + 1)
    assert pos == len(raw)


def with_header(data: bytes, depth: int, color_type: int, interlace: int) -> bytes:
    """``data`` with its IHDR's depth, colour type and interlace method
    replaced (the chunk's CRC recomputed)."""
    w, h = struct.unpack(">II", data[16:24])
    return (data[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                                                   interlace)) + data[33:])


def test_unsupported_pngs_raise():
    arr = np.zeros((4, 4, 3), np.uint8)
    plain = cycled_png(arr, 2)
    for ct, depth in ((2, 4), (6, 1), (4, 2), (3, 16), (0, 3), (5, 8)):
        with pytest.raises(ValueError, match="not a valid|not valid"):
            png.decode_png(with_header(plain, depth, ct, 0))
    with pytest.raises(ValueError, match="interlace method"):
        png.decode_png(with_header(plain, 8, 2, 2))
    with pytest.raises(ValueError, match="shorter"):  # the passes' bytes outrun the data
        png.decode_png(with_header(plain, 8, 2, 1))
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
