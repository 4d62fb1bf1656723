"""Image preprocessing: the host-side resize, and the batched train-time
augmentation on the device.

Counterpart of ``twingan_tpu/data/preprocess.py``:

- ``host_resize_uint8``/``host_resize``: every resize mode (NONE, PAD,
  CROP, RESHAPE, RANDOM_CROP, RANDOM_CROP_AND_RESHAPE) with the JAX
  signature (``rng``, ``initial_crop_hw``). The JAX package resizes with
  PIL's bilinear filter; the card's machine has no PIL, so
  ``pil_bilinear_resize`` (8-bit) and ``pil_bilinear_resize_f32`` (float32
  grayscale, mode "F") re-implement Pillow's ``Resample.c`` in numpy to
  the bit (``data/resample.py``, which imports no torch).
- ``PreprocessConfig`` field for field, with ``host_hw``;
- ``augment_batch``: the random crop, the per-image or shared horizontal
  flip, the colour distortion (fast: brightness and saturation, in one of
  2 orders; full: also hue and contrast, in one of 4), the resize to
  ``output_hw``, ``subtract_mean`` and the yiq/bgr/gray colour spaces, in
  the JAX order and with its formulas (HSV round trips included);
- ``postprocess_image``, the inverse for display.

The JAX function draws its random numbers from a PRNG key. Here they come
from an explicit ``torch.Generator`` (``draw_augmentation``), or are
injected whole as ``AugmentDraws`` (crop offsets, flip coins, the
ordering, the colour factors), which is how the parity tests hand both
packages the same draws.

``jax.image.resize(..., "bilinear")`` antialiases when it shrinks an image
and ``F.interpolate`` does not: the device resize enlarges with
``F.interpolate`` (the same function there) and shrinks with
``ops.basic.resize_bilinear``, the JAX formula.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from twingan_tpu_torch.data.resample import (  # noqa: F401 - this module's host resizes
    pil_bilinear_resize,
    pil_bilinear_resize_f32,
)
from twingan_tpu_torch.ops import basic

RESIZE_MODES = ("NONE", "PAD", "CROP", "RESHAPE", "RANDOM_CROP", "RANDOM_CROP_AND_RESHAPE")
PORTED_RESIZE_MODES = RESIZE_MODES

RGB_TO_YIQ = np.array(
    [[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]], np.float32
)
YIQ_TO_RGB = np.array(
    [[1, 0.956, 0.621], [1, -0.272, -0.647], [1, -1.106, 1.703]], np.float32
)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)
RANDOM_CROP_RATIO = 0.8
MEAN_IMAGE_SUBTRACTION_RGB = (123.68, 116.779, 103.939)

# The colour operations of each ordering, in the order they apply: the
# i-th one takes the i-th colour draw (the JAX ``distort_color``'s keys[i]).
ORDERINGS = {
    True: (("brightness", "saturation"), ("saturation", "brightness")),
    False: (("brightness", "saturation", "hue", "contrast"),
            ("saturation", "brightness", "contrast", "hue"),
            ("contrast", "hue", "brightness", "saturation"),
            ("hue", "saturation", "contrast", "brightness")),
}
# Each operation's factor: U(low, high), one per image.
COLOR_RANGES = {"brightness": (-32.0 / 255.0, 32.0 / 255.0), "saturation": (0.5, 1.5),
                "hue": (-0.2, 0.2), "contrast": (0.5, 1.5)}


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    output_hw: int = 64
    resize_mode: str = "PAD"
    color_space: str = "rgb"           # rgb | yiq | bgr | gray
    do_random_cropping: bool = False
    random_cropping_ratio: float = RANDOM_CROP_RATIO
    fast_mode: bool = True             # fast colour distortion (no hue/contrast)
    is_training: bool = False
    shared_flip: bool = False          # one coin for the whole batch
    initial_crop_hw: Optional[int] = None
    subtract_mean: bool = False

    @property
    def host_hw(self) -> int:
        """The fixed hw the host resizes to; the device crops back to output_hw."""
        if self.is_training and self.do_random_cropping:
            return int(self.output_hw / self.random_cropping_ratio)
        return self.output_hw


# ------------------------------------------------------------------ #
# Host side
# ------------------------------------------------------------------ #

def host_resize_uint8(img: np.ndarray, mode: str, new_hw: int,
                      rng: Optional[np.random.RandomState] = None,
                      initial_crop_hw: Optional[int] = None) -> np.ndarray:
    """uint8 HWC (or HW) -> uint8 HWC at (new_hw, new_hw), the JAX
    function's geometry and draws: PAD centres the image on a black
    square, CROP takes the centred square, the random crops draw their
    offsets from ``rng`` (numpy's global state when None)."""
    if mode not in RESIZE_MODES:
        raise ValueError(f"unknown resize mode {mode!r}; known: {RESIZE_MODES}")
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w = img.shape[:2]

    def bilinear(arr, hw):
        return pil_bilinear_resize(arr.astype(np.uint8), hw, hw)

    if mode == "NONE":
        return np.asarray(img, np.uint8)
    if mode == "PAD":
        if h != w:
            size = max(h, w)
            oh, ow = (size - h) // 2, (size - w) // 2
            padded = np.zeros((size, size, img.shape[2]), img.dtype)
            padded[oh: oh + h, ow: ow + w] = img
            img = padded
        img = bilinear(img, new_hw)
    elif mode == "CROP":
        if h != w:
            size = min(h, w)
            oh, ow = (h - size) // 2, (w - size) // 2
            img = img[oh: oh + size, ow: ow + size]
        img = bilinear(img, new_hw)
    elif mode == "RESHAPE":
        img = bilinear(img, new_hw)
    else:  # RANDOM_CROP, RANDOM_CROP_AND_RESHAPE
        crop_hw = new_hw if mode == "RANDOM_CROP" else int(initial_crop_hw)
        rng = rng or np.random
        if min(h, w) < crop_hw:
            img = bilinear(img, crop_hw)
            h = w = crop_hw
        oh = int(rng.randint(0, h - crop_hw + 1))
        ow = int(rng.randint(0, w - crop_hw + 1))
        img = img[oh: oh + crop_hw, ow: ow + crop_hw]
        if mode == "RANDOM_CROP_AND_RESHAPE":
            img = bilinear(img, new_hw)
    return np.asarray(img, np.uint8)


def host_resize(img: np.ndarray, mode: str, new_hw: int,
                rng: Optional[np.random.RandomState] = None,
                initial_crop_hw: Optional[int] = None) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0,1] at (new_hw, new_hw)."""
    out = host_resize_uint8(img, mode, new_hw, rng=rng, initial_crop_hw=initial_crop_hw)
    return out.astype(np.float32) / 255.0


# ------------------------------------------------------------------ #
# Device side (batched, NHWC)
# ------------------------------------------------------------------ #

def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), torch.zeros_like(maxc))
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    table = ((v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))
    out = []
    for row in table:
        c = torch.zeros_like(v)
        for k, val in enumerate(row):
            c = torch.where(i == k, val, c)
        out.append(c)
    return torch.stack(out, dim=-1)


def adjust_brightness(x: torch.Tensor, delta) -> torch.Tensor:
    return x + delta


def adjust_saturation(x: torch.Tensor, factor) -> torch.Tensor:
    hsv = rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def adjust_hue(x: torch.Tensor, delta) -> torch.Tensor:
    hsv = rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def adjust_contrast(x: torch.Tensor, factor) -> torch.Tensor:
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    return mean + factor * (x - mean)


def _apply_color(op: str, x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``factor`` is [B]: broadcast per image as the JAX draws' shapes
    ([B,1,1,1] for brightness and contrast, [B,1,1] inside HSV)."""
    if op == "brightness":
        return adjust_brightness(x, factor.view(-1, 1, 1, 1))
    if op == "contrast":
        return adjust_contrast(x, factor.view(-1, 1, 1, 1))
    if op == "saturation":
        return adjust_saturation(x, factor.view(-1, 1, 1))
    return adjust_hue(x, factor.view(-1, 1, 1))


def distort_color(x: torch.Tensor, ordering: int, factors: Sequence[torch.Tensor],
                  fast_mode: bool = True) -> torch.Tensor:
    """The colour operations of ``ordering`` with their per-image factors,
    then the clip to [0, 1]."""
    orders = ORDERINGS[fast_mode]
    for op, factor in zip(orders[ordering % len(orders)], factors):
        x = _apply_color(op, x, factor)
    return torch.clamp(x, 0.0, 1.0)


@dataclasses.dataclass
class AugmentDraws:
    """The random numbers of one ``augment_batch`` call: crop offsets [B]
    (None without a crop), flip coins ([B] bool, or one 0-dim bool when
    shared), the colour ordering and the factors [B] of its operations in
    the order they apply (empty without colour distortion)."""
    crop_y: Optional[torch.Tensor]
    crop_x: Optional[torch.Tensor]
    flip: Optional[torch.Tensor]
    ordering: int = 0
    color: tuple = ()


def _crops(cfg: PreprocessConfig, hw: int) -> bool:
    return cfg.is_training and cfg.do_random_cropping and hw > cfg.output_hw


def _distorts(cfg: PreprocessConfig, channels: int) -> bool:
    return cfg.is_training and cfg.color_space != "gray" and channels == 3


def draw_augmentation(cfg: PreprocessConfig, shape: Sequence[int],
                      generator: torch.Generator) -> AugmentDraws:
    """Draws for a batch of ``shape`` [B, H, W, C] from ``generator``, on its
    device: crop offsets, flips, the ordering (the JAX package's 4-way draw,
    clipped to 2 in fast mode), then one factor per operation."""
    b, hw, _, c = shape
    dev = generator.device
    draws = AugmentDraws(None, None, None)
    if not cfg.is_training:
        return draws
    if _crops(cfg, hw):
        span = hw - cfg.output_hw + 1
        draws.crop_y = torch.randint(0, span, (b,), generator=generator, device=dev)
        draws.crop_x = torch.randint(0, span, (b,), generator=generator, device=dev)
    n = () if cfg.shared_flip else (b,)
    draws.flip = torch.rand(n, generator=generator, device=dev) < 0.5
    if _distorts(cfg, c):
        ordering = int(torch.randint(0, 4, (), generator=generator, device=dev))
        draws.ordering = min(ordering, 1) if cfg.fast_mode else ordering
        ops = ORDERINGS[cfg.fast_mode][draws.ordering]
        draws.color = tuple(
            torch.empty(b, device=dev).uniform_(*COLOR_RANGES[op], generator=generator)
            for op in ops)
    return draws


def resize_bilinear(x: torch.Tensor, hw: int) -> torch.Tensor:
    """NHWC bilinear resize to (hw, hw) with half-pixel centres, as
    ``jax.image.resize`` computes it (antialiased where it shrinks)."""
    if x.shape[1] == hw and x.shape[2] == hw:
        return x
    if x.shape[1] > hw or x.shape[2] > hw:
        return basic.resize_bilinear(x, hw, hw)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(hw, hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def augment_batch(images: torch.Tensor, cfg: PreprocessConfig,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[AugmentDraws] = None) -> torch.Tensor:
    """The device-side tail of the training preprocess. ``images``:
    [B, host_hw, host_hw, C], float in [0,1] or uint8. Random numbers come
    from ``draws`` or else from ``generator`` (one of them is needed in
    training mode). Returns float32 NHWC at ``output_hw``."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    if cfg.is_training:
        if draws is None:
            if generator is None:
                raise ValueError("augment_batch in training mode needs a generator or draws")
            draws = draw_augmentation(cfg, x.shape, generator)
        if _crops(cfg, x.shape[1]):
            out = cfg.output_hw
            x = torch.stack([img[y:y + out, xo:xo + out] for img, y, xo in
                             zip(x, draws.crop_y.tolist(), draws.crop_x.tolist())])
        flip = draws.flip.to(x.device)
        x = torch.where(flip.view(-1, 1, 1, 1) if flip.dim() else flip, x.flip(2), x)
        if _distorts(cfg, x.shape[-1]):
            x = distort_color(x, draws.ordering, [f.to(x.device) for f in draws.color],
                              cfg.fast_mode)
    x = resize_bilinear(x, cfg.output_hw)
    if cfg.subtract_mean and x.shape[-1] == 3:
        # The subtraction runs last, as in the JAX package.
        x = x * 255.0 - x.new_tensor(MEAN_IMAGE_SUBTRACTION_RGB)
    if cfg.color_space == "yiq":
        x = x @ x.new_tensor(RGB_TO_YIQ).T
    elif cfg.color_space == "bgr":
        x = x.flip(-1)
    elif cfg.color_space == "gray" and x.shape[-1] == 3:
        x = torch.sum(x * x.new_tensor(GRAY_WEIGHTS), dim=-1, keepdim=True)
    return x


def postprocess_image(x: torch.Tensor, color_space: str = "rgb",
                      subtract_mean: bool = False) -> torch.Tensor:
    """The inverse for display: back to RGB, the channel means re-added and
    rescaled to [0,1] where they were subtracted, clipped to [0, 1]."""
    if color_space == "yiq":
        x = x @ x.new_tensor(YIQ_TO_RGB).T
    elif color_space == "bgr":
        x = x.flip(-1)
    if subtract_mean and x.shape[-1] == 3:
        x = (x + x.new_tensor(MEAN_IMAGE_SUBTRACTION_RGB)) / 255.0
    if x.shape[-1] > 3:
        x = torch.sum(x, dim=-1, keepdim=True)
    return torch.clamp(x, 0.0, 1.0)
