"""Host-side image resize for inference.

Counterpart of ``host_resize`` / ``host_resize_uint8`` in
``twingan_tpu/data/preprocess.py`` for the modes serving uses, ``RESHAPE``
and ``NONE`` (the training modes and the device-side augmentation belong to
the data slice). An image already at ``new_hw`` is returned as it is:
PIL's bilinear resize to the same size is the identity, so only a real
resize imports PIL, inside the function.
"""

from __future__ import annotations

import numpy as np

PORTED_RESIZE_MODES = ("NONE", "RESHAPE")


def host_resize_uint8(img: np.ndarray, mode: str, new_hw: int) -> np.ndarray:
    """uint8 HWC (or HW) -> uint8 HWC at (new_hw, new_hw) for RESHAPE."""
    if mode not in PORTED_RESIZE_MODES:
        raise NotImplementedError(f"resize mode {mode} is not ported to twingan_tpu_torch yet")
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if mode == "NONE" or img.shape[:2] == (new_hw, new_hw):
        return np.asarray(img, np.uint8)
    from PIL import Image as PILImage

    arr = img.astype(np.uint8)
    pil = PILImage.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
    out = np.asarray(pil.resize((new_hw, new_hw), PILImage.BILINEAR), np.uint8)
    return out[:, :, None] if out.ndim == 2 else out


def host_resize(img: np.ndarray, mode: str, new_hw: int) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0,1] at (new_hw, new_hw)."""
    return host_resize_uint8(img, mode, new_hw).astype(np.float32) / 255.0
