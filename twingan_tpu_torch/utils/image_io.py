"""Image file IO for the inference CLI.

Counterpart of ``imread_rgb`` / ``imsave_float`` in
``twingan_tpu/utils/image_io.py``. PIL is imported inside each function, so
importing this module (and the serving path) needs no PIL.
"""

from __future__ import annotations

import os

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """uint8 HWC RGB (grayscale/RGBA converted)."""
    from PIL import Image as PILImage

    img = PILImage.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def imsave_float(path: str, img: np.ndarray, fast: bool = False) -> None:
    """Save a float image in [0,1] (clipped) as 8-bit; ``fast`` trades file
    size for encode time (zlib level 1)."""
    from PIL import Image as PILImage

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    PILImage.fromarray(arr).save(path, compress_level=1 if fast else 6)
