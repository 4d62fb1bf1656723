"""Pillow's bilinear resize in numpy, for machines without PIL.

The JAX package resizes host images with PIL's bilinear filter; the card's
machine has no PIL. This module re-implements Pillow's ``Resample.c`` to
the bit for the two image kinds the port resizes on the host:

- ``pil_bilinear_resize``: 8-bit images (mode L or RGB), as the data path
  and the serving combine resize them. The float64 coefficients are rounded
  to 22-bit fixed point; a horizontal pass into a uint8 image, then a
  vertical one, each output ``clip8((1 << 21) + sum(in * k)) >> 22``.
- ``pil_bilinear_resize_f32``: float32 grayscale images (mode "F"), as the
  Haar face detector shrinks its input and builds its pyramid. Pillow's
  32-bit path keeps the normalized float64 coefficients unrounded, sums
  each output in float64 from the first tap to the last, and stores it as
  float32, the horizontal pass's image included.

Both widen the filter's support by the scale when shrinking (PIL's
antialiasing) and skip a pass whose size does not change. The module
imports numpy only, so that the face detector's worker processes need no
torch.
"""

from __future__ import annotations

import numpy as np

# Pillow's fixed-point precision for 8-bit resampling (Resample.c).
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_weights(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for the bilinear filter (support 1):
    each output's first input index [out], its normalized float64 weights
    [out, ksize] and the mask of the taps inside its window."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; negatives clamp to 0 just after.
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    inside = x[None, :] < xmax[:, None]
    t = np.abs(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(inside & (t < 1.0), 1.0 - t, 0.0)
    # The weights' sum, accumulated left to right as the C loop does.
    ww = np.cumsum(w, axis=1)[:, -1:]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    return xmin, np.where(inside, w, 0.0), inside


def _bilinear_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``_bilinear_weights`` rounded as ``normalize_coeffs_8bpc`` rounds
    them: each output's first input index and its int weights."""
    xmin, w, inside = _bilinear_weights(in_size, out_size)
    k = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, np.where(inside, k, 0)


def _taps(xmin: np.ndarray, ksize: int, in_size: int) -> np.ndarray:
    """The input index of every tap [out, ksize], clamped into the image
    (the taps past a window's end have weight 0)."""
    return np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` (0 rows, 1
    columns) of a uint8 [H, W, C] image: each output gathers its window,
    one tap at a time (whole lines of the image, the resampled axis moved
    to the front), and sums in int32 (at most 255 x 2^22 plus the rounding
    term, under 2^31)."""
    lines = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    in_size = lines.shape[0]
    xmin, k = _bilinear_coeffs(in_size, out_size)
    idx = _taps(xmin, k.shape[1], in_size)
    k = k.astype(np.int32).reshape(out_size, -1, *([1] * (lines.ndim - 1)))
    acc = np.full((out_size,) + lines.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for tap in range(k.shape[1]):
        acc += lines[idx[:, tap]] * k[:, tap]
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def pil_bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [out_h, out_w, C], equal to PIL's
    ``Image.resize((out_w, out_h), BILINEAR)`` of the same image (mode L
    for one channel, RGB for three); the same size is a copy, as in PIL."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if w != out_w:  # Pillow skips a pass whose size does not change
        img = _resample_axis(img, out_w, axis=1)
    if h != out_h:
        img = _resample_axis(img, out_h, axis=0)
    return np.array(img, np.uint8)


def _resample_axis_f32(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 32-bit float resample along ``axis`` of a
    float32 [H, W] image: float64 sums, tap by tap in the C loop's order
    (a tap past the window's end adds an exact 0), stored as float32."""
    lines = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    in_size = lines.shape[0]
    xmin, w, _ = _bilinear_weights(in_size, out_size)
    idx = _taps(xmin, w.shape[1], in_size)
    w = w.reshape(out_size, -1, *([1] * (lines.ndim - 1)))
    acc = np.zeros((out_size,) + lines.shape[1:], np.float64)
    for tap in range(w.shape[1]):
        acc += lines[idx[:, tap]].astype(np.float64) * w[:, tap]
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def pil_bilinear_resize_f32(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """float32 [H, W] -> float32 [out_h, out_w], equal to PIL's
    ``Image.fromarray(img).resize((out_w, out_h), BILINEAR)`` (mode "F");
    the same size is a copy, as in PIL."""
    img = np.asarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"pil_bilinear_resize_f32 takes a 2-D image, got shape {img.shape}")
    h, w = img.shape
    if w != out_w:
        img = _resample_axis_f32(img, out_w, axis=1)
    if h != out_h:
        img = _resample_axis_f32(img, out_h, axis=0)
    return np.array(img, np.float32)
