"""PNG decoding without PIL.

The card's machine has no PIL, and the JAX package decodes every image
with it (``twingan_tpu/data/datasets.py:_decode_image``). ``decode_png``
replaces that call for PNG: it returns the uint8 HWC array that
``PIL.Image.open(...).convert("RGB")`` gives, byte for byte, for
every valid image, interlaced (Adam7) or not:

- gray (1, 2, 4 and 8 bits; the low depths scaled to 0-255 as PIL scales
  them), gray + alpha (8 bits; alpha dropped, as PIL's LA -> RGB drops it);
- RGB and RGBA (8 bits; alpha dropped);
- palette (1, 2, 4 and 8 bits; looked up in PLTE, an index past its
  entries black, as Pillow 12 gives it; tRNS ignored, as PIL's P -> RGB
  ignores it);
- 16 bits: gray as PIL converts its mode I;16, each sample clipped at 255
  (not scaled); gray + alpha, RGB and RGBA by their high bytes, as PIL
  reads them.

An interlaced file's seven passes are each unfiltered as an image of its
own and scattered into place. Invalid headers, chunks failing their CRC
and short image data raise ``ValueError``.

The data is inflated with ``zlib`` and its rows unfiltered by the port's
native library (``twingan_tpu_torch/native``), or by ``unfilter_numpy``
where that library could not be built. Sub and Up are vectorised in numpy;
Average and Paeth depend on the byte just decoded to their left and loop
over a row's pixels, which costs about 0.1 s for a 256 px image in Python:
that is what the native loop is for (PIL-written files are full of Paeth
rows).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from twingan_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTER_NAMES = ("none", "sub", "up", "average", "paeth")


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_numpy(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of the native unfilter: ``raw`` holds ``rows``
    scanlines of a filter-type byte and ``stride`` filtered bytes; returns
    the [rows, stride] unfiltered bytes."""
    lines = np.asarray(raw, np.uint8).reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for r in range(rows):
        kind, src = int(lines[r, 0]), lines[r, 1:].astype(np.int64)
        if kind == 0:
            cur = src
        elif kind == 1:
            # Sub: each byte adds the one bpp to its left, a running sum
            # along the row within each of the bpp byte lanes.
            pad = (-stride) % bpp
            lanes = np.concatenate([src, np.zeros(pad, np.int64)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) % 256).reshape(-1)[:stride]
        elif kind == 2:
            cur = (src + prev) % 256
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, int(prev[i - bpp]) if i >= bpp else 0)
                cur[i] = (int(src[i]) + pred) % 256
        else:
            raise ValueError(f"PNG row {r} has filter type {kind}, not 0-4")
        out[r] = cur
        prev = cur.astype(np.int64)
    return out


def unfilter(raw: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    """[rows, stride] unfiltered bytes, by the native library where it is
    built, else by ``unfilter_numpy``."""
    if len(raw) < rows * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    lib = native.load()
    if lib is None:
        return unfilter_numpy(np.frombuffer(raw, np.uint8, rows * (stride + 1)), rows, stride,
                              bpp)
    src = np.frombuffer(raw, np.uint8, rows * (stride + 1))
    out = np.empty((rows, stride), np.uint8)
    status = lib.twin_png_unfilter(src.ctypes.data, rows, stride, bpp, out.ctypes.data)
    if status < 0:
        raise ValueError(f"PNG row {-status - 1} has a filter type that is not 0-4")
    return out


def read_header(data: bytes) -> dict:
    """IHDR's fields, PLTE and the concatenated IDAT bytes of a PNG file."""
    info: dict = {"idat": []}
    for kind, body in _chunks(bytes(data)):
        if kind == b"IHDR":
            (info["width"], info["height"], info["depth"], info["color_type"],
             _, _, info["interlace"]) = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            info["palette"] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            info["idat"].append(body)
    if "width" not in info:
        raise ValueError("PNG file has no IHDR chunk")
    info["idat"] = b"".join(info["idat"])
    return info


# Adam7: each pass's first column and row, and its column and row steps.
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def passes(info: dict):
    """(x0, y0, dx, dy, width, height) of each non-empty pass of the image:
    the whole image when it is not interlaced, else its Adam7 passes (an
    empty pass has no bytes, not even filter types)."""
    width, height = info["width"], info["height"]
    if not info["interlace"]:
        yield 0, 0, 1, 1, width, height
        return
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            yield x0, y0, dx, dy, pw, ph


def row_filters(data: bytes) -> list:
    """The filter type of every row of a PNG file, pass by pass (the tests
    use it to show which filters their fixtures cover)."""
    info = read_header(data)
    channels = CHANNELS[info["color_type"]]
    raw = zlib.decompress(info["idat"])
    out, pos = [], 0
    for *_, pw, ph in passes(info):
        stride = (pw * channels * info["depth"] + 7) // 8
        out += [raw[pos + r * (stride + 1)] for r in range(ph)]
        pos += ph * (stride + 1)
    return out


def _check_header(info: dict) -> int:
    """The samples a pixel of a valid IHDR has; raises for invalid ones."""
    color_type, depth = info["color_type"], info["depth"]
    if color_type not in CHANNELS:
        raise ValueError(f"PNG color type {color_type} is not a valid one")
    valid = (1, 2, 4, 8, 16) if color_type == 0 else (1, 2, 4, 8) if color_type == 3 else (8, 16)
    if depth not in valid:
        raise ValueError(f"PNG color type {color_type} with bit depth {depth} is not valid")
    if info["interlace"] not in (0, 1):
        raise ValueError(f"PNG interlace method {info['interlace']} is not 0 or 1")
    return CHANNELS[color_type]


def _samples(raw: memoryview, width: int, height: int, channels: int, depth: int) -> tuple:
    """Unfilter one image (or one Adam7 pass) from the front of ``raw``:
    its samples [height, width, channels] (uint8 below 16 bits, unscaled;
    uint16 at 16) and the bytes it took."""
    stride = (width * channels * depth + 7) // 8
    rows = unfilter(raw, height, stride, max(1, channels * depth // 8))
    if depth < 8:
        # Sub-byte samples, most significant first, each row padded to a byte.
        bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(axis=-1).astype(np.uint8)[:, :, None]
    elif depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    else:
        samples = rows.reshape(height, width, channels)
    return samples, height * (stride + 1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> uint8 [H, W, 3], as PIL's ``convert("RGB")``."""
    info = read_header(data)
    width, height, depth = info["width"], info["height"], info["depth"]
    color_type = info["color_type"]
    channels = _check_header(info)
    raw = memoryview(zlib.decompress(info["idat"]))
    pixels = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes(info):
        pixels[y0::dy, x0::dx], used = _samples(raw[pos:], pw, ph, channels, depth)
        pos += used
    if color_type == 3:
        if "palette" not in info:
            raise ValueError("palette PNG file has no PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        pal = info["palette"][:256]
        table[: len(pal)] = pal
        return table[pixels[:, :, 0]]
    if depth < 8:
        pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    elif depth == 16:
        # PIL opens 16-bit gray as mode I;16 and converts it to RGB clipped
        # at 255; every other 16-bit kind it reads as its high bytes.
        pixels = (np.minimum(pixels, 255) if color_type == 0 else pixels >> 8).astype(np.uint8)
    if channels in (1, 2):
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """A uint8 image ([H, W] gray, [H, W, 1|3|4]) as a PNG file: 8 bits,
    every row unfiltered, deflated at zlib ``level``; no PIL needed."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    color = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1] if img.ndim == 3 else 0)}[img.ndim]
    if color is None:
        raise ValueError(f"cannot encode an image of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))
