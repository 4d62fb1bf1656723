"""Elementary ops of the translation and training paths, in PyTorch.

Counterpart of ``twingan_tpu/ops/basic.py``. Image tensors are NHWC by
default, as in the JAX package; the spatial ops take ``nchw=True`` for the
modules, which compute on NCHW views. Every function keeps the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from twingan_tpu_torch.parallel.multihost import all_reduce_mean


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """max(alpha*x, x), the default activation of every conv."""
    return torch.maximum(x * alpha, x)


def pixel_norm(x: torch.Tensor, eps: float = 1e-6, dim: int = -1) -> torch.Tensor:
    """Pixelwise feature-vector normalization over the channel axis."""
    ms = torch.mean(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(ms + eps)


def equalized_lr_scale(fan_in: int, kernel_size: int = 1) -> float:
    """He constant sqrt(2 / (fan_in * k^2)) applied to the layer input."""
    return math.sqrt(2.0 / (fan_in * kernel_size * kernel_size))


def upsample_nearest_2x(x: torch.Tensor, nchw: bool = False) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample."""
    if nchw:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)


def avg_pool_2x(x: torch.Tensor, nchw: bool = False) -> torch.Tensor:
    """2x2 stride-2 average pool (VALID)."""
    if nchw:
        return F.avg_pool2d(x, 2)
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def blend(new: torch.Tensor, old: torch.Tensor, alpha) -> torch.Tensor:
    """Fade-in blend used during growth: new*alpha + (1-alpha)*old."""
    alpha = torch.as_tensor(alpha, dtype=new.dtype, device=new.device)
    return new * alpha + (1 - alpha) * old


def minibatch_stddev(x: torch.Tensor, eps: float | None = None, num_groups: int = 1,
                     nchw: bool = False, group=None) -> torch.Tensor:
    """Append the across-minibatch stddev as one constant feature map.

    The biased (population) variance over the batch axis at each location,
    its square root after adding eps (1e-8 in fp32, 1e-6 in other dtypes),
    averaged to one scalar per group of ``num_groups`` contiguous equal
    sub-batches and tiled to [B, H, W, 1]. Groups aligned to the sub-batch
    boundaries make one pass over concatenated batches compute each pass's
    own statistic. Under a process group (``group``; each process holding
    its rows of every sub-batch, in the same layout) each group's mean and
    then its variance are averaged over the processes, differentiably: the
    statistic of the whole batch, as the JAX package's global view takes
    it."""
    if eps is None:
        eps = 1e-8 if x.dtype == torch.float32 else 1e-6
    t = x if nchw else x.permute(0, 3, 1, 2)
    b, c, h, w = t.shape
    groups = max(num_groups, 1)
    if b % groups:
        raise ValueError(f"batch {b} not divisible by num_groups {num_groups}")
    tg = t.reshape(groups, b // groups, c, h, w)
    mean = all_reduce_mean(torch.mean(tg, dim=1, keepdim=True), group)
    var = all_reduce_mean(torch.mean(torch.square(tg - mean), dim=1, keepdim=True), group)
    std = torch.sqrt(var + torch.tensor(eps, dtype=x.dtype, device=x.device))
    scalar = torch.mean(std, dim=(1, 2, 3, 4))  # [groups]
    tiled = scalar[:, None, None, None, None].expand(groups, b // groups, 1, h, w)
    out = torch.cat([t, tiled.reshape(b, 1, h, w).to(x.dtype)], dim=1)
    return out if nchw else out.permute(0, 2, 3, 1)


def gdrop(x: torch.Tensor, strength, generator: torch.Generator | None = None,
          noise: torch.Tensor | None = None, mode: str = "prop",
          nchw: bool = False) -> torch.Tensor:
    """PGGAN's generalized multiplicative noise: x * (1 + strength *
    sqrt(C) * n), one n ~ N(0, 1) per (example, channel), broadcast over
    the spatial axes. ``noise`` [B, C] injects the draw (the tests pass the
    JAX package's); otherwise it comes from ``generator``."""
    if mode != "prop":
        raise ValueError(f"unsupported gdrop mode: {mode}")
    b, c = x.shape[0], x.shape[1 if nchw else -1]
    if noise is None:
        noise = torch.randn((b, c), generator=generator, device=x.device, dtype=x.dtype)
    noise = noise.reshape(b, c).to(x.device, x.dtype)
    rnd = noise[:, :, None, None] if nchw else noise[:, None, None, :]
    coef = (torch.as_tensor(strength, dtype=x.dtype, device=x.device)
            * torch.tensor(math.sqrt(c), dtype=x.dtype, device=x.device))
    return x * (rnd * coef + torch.tensor(1, dtype=x.dtype, device=x.device))


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """The [in, out] weights of ``jax.image.resize``'s "bilinear" along one
    axis, in fp32 as it computes them: a triangle kernel at the half-pixel
    sample positions, widened by 1 / scale when shrinking (antialiasing),
    each column normalized to sum 1, zero where the sample lies outside."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
              * torch.tensor(inv_scale, dtype=torch.float32) - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                                 device=device)[:, None])
    w = torch.clamp(1.0 - x / torch.tensor(kernel_scale, dtype=torch.float32), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Differentiable bilinear resize of an NHWC tensor, the function of
    ``jax.image.resize(x, ..., "bilinear")``: it antialiases when it
    shrinks (the triangle kernel widened by the scale), which
    ``F.interpolate`` does not. An axis of unchanged size is left alone."""
    if x.shape[1] != height:
        w = _resize_weights(x.shape[1], height, x.device).to(x.dtype)
        x = torch.einsum("bhwc,hH->bHwc", x, w)
    if x.shape[2] != width:
        w = _resize_weights(x.shape[2], width, x.device).to(x.dtype)
        x = torch.einsum("bhwc,wW->bhWc", x, w)
    return x


def local_response_norm(x: torch.Tensor, depth_radius: int = 5, bias: float = 1.0,
                        alpha: float = 1.0, beta: float = 0.5, dim: int = -1) -> torch.Tensor:
    """``tf.nn.lrn`` over the channel axis ``dim`` (the last, NHWC, by
    default; ``dim=1`` for NCHW): out_i = x_i / (bias + alpha *
    sum_{j in [i-r, i+r]} x_j^2) ** beta, the windowed sum of squares as a
    difference of cumulative sums over the zero-padded channels, as the JAX
    function takes it."""
    sq = torch.square(x).movedim(dim, -1)
    csum = torch.cumsum(F.pad(sq, (depth_radius + 1, depth_radius)), dim=-1)
    window = 2 * depth_radius + 1
    sums = csum[..., window:] - csum[..., :-window]
    return x / torch.pow(bias + alpha * sums.movedim(-1, dim), beta)
