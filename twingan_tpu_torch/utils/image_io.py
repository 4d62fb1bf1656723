"""Image file IO for the inference CLI, the runner's sample grids and the
server.

Counterpart of ``imread_rgb``, ``imsave_float``, ``save_image_grid``,
``numpy_to_base64``, ``base64_to_numpy`` and ``stack_comparison`` in
``twingan_tpu/utils/image_io.py``. PNG is read and written without PIL
(``data/png.py``), recognised by its signature whatever the file is
called; PIL is imported inside the functions only for other formats, and
``decode_image`` raises ``ImportError`` naming PIL where it is missing. So
importing this module, and reading or writing PNG, needs no PIL.
"""

from __future__ import annotations

import base64
import io
import os
from typing import Optional, Sequence

import numpy as np

from twingan_tpu_torch.data.png import SIGNATURE, decode_png, encode_png


def decode_image(data: bytes, fmt: Optional[str] = None) -> np.ndarray:
    """Encoded image bytes -> uint8 [H, W, 3], as PIL's ``convert("RGB")``.
    A PNG file is decoded without PIL whatever ``fmt`` says, since its
    signature names it, as PIL's own sniffing does; anything else goes to
    PIL, and raises ``ImportError`` naming PIL where it is not installed."""
    data = bytes(data)
    if data[:8] == SIGNATURE:
        return decode_png(data)
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(
            f"decoding a {fmt or 'non-PNG'} image needs PIL, which is not installed "
            "here; only PNG decodes without it (convert datasets for such a machine with "
            "encode_format='png')") from e
    img = PILImage.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def imread_rgb(path: str) -> np.ndarray:
    """uint8 HWC RGB (grayscale/RGBA converted)."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def imsave_float(path: str, img: np.ndarray, fast: bool = False) -> None:
    """Save a float image in [0,1] (clipped) as 8-bit; ``fast`` trades file
    size for encode time (zlib level 1). PNG files are written by the
    port's own encoder (``data/png.py``), so that sample grids need no PIL;
    other formats by PIL."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(arr, level=1 if fast else 6))
        return
    from PIL import Image as PILImage

    PILImage.fromarray(arr).save(path)


def save_image_grid(path: str, images: np.ndarray, columns: int | None = None) -> None:
    """[N,H,W,C] float batch -> one row-major mosaic PNG."""
    images = np.asarray(images, np.float32)
    n, h, w, c = images.shape
    if columns is None:
        columns = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / columns))
    grid = np.zeros((rows * h, columns * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, columns)
        grid[r * h: (r + 1) * h, col * w: (col + 1) * w] = images[i]
    imsave_float(path, grid)


def numpy_to_base64(image: np.ndarray, fmt: str = "PNG") -> str:
    """uint8 HWC image -> 'data:image/FMT;base64,...' data URI. PNG is
    encoded without PIL; other formats need it."""
    arr = np.asarray(image, np.uint8)
    if fmt.upper() == "PNG":
        raw = encode_png(arr)
    else:
        from PIL import Image as PILImage

        buf = io.BytesIO()
        PILImage.fromarray(arr).save(buf, format=fmt)
        raw = buf.getvalue()
    return f"data:image/{fmt};base64," + base64.b64encode(raw).decode()


def base64_to_numpy(data: str) -> np.ndarray:
    """Inverse of numpy_to_base64; accepts raw base64 or a data URI. The
    array is a writable copy: callers draw on it in place
    (``utils/visualization.py``)."""
    if data.startswith("data:"):
        data = data.split(",", 1)[1]
    return np.array(decode_image(base64.b64decode(data)), np.uint8)


def stack_comparison(pairs: Sequence[np.ndarray]) -> np.ndarray:
    """Interleave equal-shape batches row-wise: image i of each batch, one
    above the other, makes image i of the result ([N, K*H, W, C])."""
    stacked = np.concatenate([np.asarray(p)[None] for p in pairs], axis=0)  # [K,N,H,W,C]
    k, n, h, w, c = stacked.shape
    return stacked.transpose(1, 0, 2, 3, 4).reshape(n, k * h, w, c)
