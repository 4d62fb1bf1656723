"""PNG decoding without PIL.

The card's machine has no PIL, and the JAX package decodes every image
with it (``twingan_tpu/data/datasets.py:_decode_image``). ``decode_png``
replaces that call for PNG: it returns the uint8 HWC array that
``PIL.Image.open(...).convert("RGB")`` gives, byte for byte, for
non-interlaced images of these kinds:

- gray (1, 2, 4 and 8 bits; the low depths scaled to 0-255 as PIL scales
  them), gray + alpha (8 bits; alpha dropped, as PIL's LA -> RGB drops it);
- RGB and RGBA (8 bits; alpha dropped);
- palette (1, 2, 4 and 8 bits; looked up in PLTE, whose missing entries
  PIL fills with the gray ramp (i, i, i); tRNS ignored, as PIL's P -> RGB
  ignores it).

Interlaced files and 16-bit samples raise ``ValueError``.

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


def row_filters(data: bytes) -> list:
    """The filter type of every row of a non-interlaced PNG file (the
    tests use it to show which filters their fixtures cover)."""
    info = read_header(data)
    channels = CHANNELS[info["color_type"]]
    stride = (info["width"] * channels * info["depth"] + 7) // 8
    raw = zlib.decompress(info["idat"])
    return [raw[r * (stride + 1)] for r in range(info["height"])]


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> uint8 [H, W, 3], as PIL's ``convert("RGB")``."""
    info = read_header(data)
    width, height, depth = info["width"], info["height"], info["depth"]
    color_type = info["color_type"]
    if color_type not in CHANNELS:
        raise ValueError(f"PNG color type {color_type} is not a valid one")
    if info["interlace"]:
        raise ValueError("interlaced PNG files are not supported")
    if depth == 16:
        raise ValueError("16-bit PNG files are not supported")
    channels = CHANNELS[color_type]
    if depth != 8 and color_type not in (0, 3):
        raise ValueError(f"PNG color type {color_type} with bit depth {depth} is not valid")
    stride = (width * channels * depth + 7) // 8
    rows = unfilter(zlib.decompress(info["idat"]), height, stride, max(1, channels * depth // 8))
    if depth < 8:
        # Sub-byte samples, most significant first, each row padded to a byte.
        bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(axis=-1).astype(np.uint8)
        if color_type == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        pixels = samples[:, :, None]
    else:
        pixels = rows.reshape(height, width, channels)
    if color_type == 3:
        if "palette" not in info:
            raise ValueError("palette PNG file has no PLTE chunk")
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        pal = info["palette"][:256]
        table[: len(pal)] = pal
        return table[pixels[:, :, 0]]
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
