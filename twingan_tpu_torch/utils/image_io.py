"""Image file IO for the inference CLI and the runner's sample grids.

Counterpart of ``imread_rgb``, ``imsave_float``, ``save_image_grid`` and
``stack_comparison`` in ``twingan_tpu/utils/image_io.py``. PNG files are
written without PIL; PIL is imported inside the functions that read files
or write other formats, so importing this module (and the serving and
training paths) needs no PIL.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from twingan_tpu_torch.data.png import encode_png


def imread_rgb(path: str) -> np.ndarray:
    """uint8 HWC RGB (grayscale/RGBA converted)."""
    from PIL import Image as PILImage

    img = PILImage.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


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


def stack_comparison(pairs: Sequence[np.ndarray]) -> np.ndarray:
    """Interleave equal-shape batches row-wise: image i of each batch, one
    above the other, makes image i of the result ([N, K*H, W, C])."""
    stacked = np.concatenate([np.asarray(p)[None] for p in pairs], axis=0)  # [K,N,H,W,C]
    k, n, h, w, c = stacked.shape
    return stacked.transpose(1, 0, 2, 3, 4).reshape(n, k * h, w, c)
