"""Flax's stock layers, with the Flax modules' parameter names.

The classifier zoo (``models/classifiers.py``, ``inception.py``,
``nasnet.py``) and the alternative GANs (``models/dcgan.py``,
``cyclegan.py``, ``pix2pix.py``) are built from stock Flax layers, not the
PGGAN layers of ``models/layers.py``. These are their counterparts, each
with the Flax module's parameter names, so a Flax tree maps onto
``state_dict`` keys one to one (``bridge.py``):

- ``Conv``: ``nn.Conv`` with ``kernel`` stored OIHW (a depthwise kernel
  (C, 1, kh, kw)) and ``bias``, TF "SAME" or "VALID" padding. SAME pads
  ``total // 2`` before and the rest after, as XLA does; where that is
  uneven (stride 2 on an even input: (0, 1); an even kernel at stride 1,
  k4: (1, 2)) it is an explicit ``F.pad``, else the conv's own padding;
- ``ConvTranspose``: ``nn.ConvTranspose`` (``transpose_kernel=False``),
  its HWIO kernel stored OIHW like any other 4-D kernel. Flax's transposed
  conv is a conv of the stride-dilated input with the kernel as it is;
  ``F.conv_transpose2d`` flips its kernel, so ``forward`` hands it the
  kernel flipped in both spatial axes and laid out (in, out, kh, kw). lax
  pads the dilated input by (a, b) (``_conv_transpose_padding``);
  ``F.conv_transpose2d(padding=p)`` pads it by k - 1 - p on both sides, so
  the larger side is padded and the extra rows and columns are cropped
  (k3 s2 SAME: (2, 1), so 2H + 1 rows of which the first 2H are Flax's);
- ``Dense``: ``nn.Dense``, ``kernel`` [in, out] as in Flax (and as the
  PGGAN layers store theirs), and ``bias``;
- ``BatchNorm``: ``nn.BatchNorm`` over the channels of NCHW tensors:
  ``scale``, ``bias``, buffers ``mean`` and ``var`` (the Flax
  ``batch_stats``). Train mode normalizes with the batch's biased moments
  in the E[x^2] - E[x]^2 form, clamped at 0 (Flax's fast variance), and
  with ``update`` (the default) moves the running moments by ``momentum``
  with that same biased variance (``nn.BatchNorm2d`` would feed the
  unbiased one). Under a process group the moments are the whole batch's,
  one all-reduce of (mean, mean_sq) (``ops.norms.moments``), as the JAX
  package's global view takes them. Eval mode uses the running moments;
- ``LayerNorm``: Flax's, over the channel axis only;
- ``InstanceNorm``: CycleGAN's instance norm (epsilon 1e-3), ``scale`` and
  ``bias``.

Norm statistics are taken in at least fp32, as Flax takes them.
``reset_parameters`` draws with Flax's initializers (not its numbers):
kernels LeCun normal (a normal of variance 1 / fan_in truncated at two
standard deviations), biases 0, norm scales 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch import parallel
from twingan_tpu_torch.ops import norms

# Flax's lecun_normal: a unit normal truncated to [-2, 2], whose stddev is
# this; the kernel's is 1 / sqrt(fan_in).
TRUNC_STD = 0.87962566103423978


def pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) of XLA's ``SAME`` padding along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def out_size(size: int, kernel: int, stride: int, padding: str) -> int:
    """The output size along one axis of a conv or pool."""
    if padding == "SAME":
        return -(-size // stride)
    return (size - kernel) // stride + 1


def pad_same(x: torch.Tensor, kernel, stride, padding: str, value: float = 0.0) -> torch.Tensor:
    """``x`` (NCHW) padded for a ``SAME`` window, as XLA pads it."""
    if padding == "VALID":
        return x
    (kh, kw), (sh, sw) = pair(kernel), pair(stride)
    top, bottom = same_pads(x.shape[2], kh, sh)
    left, right = same_pads(x.shape[3], kw, sw)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def transpose_pads(kernel: int, stride: int, padding: str) -> tuple[int, int]:
    """lax's padding (before, after) of the stride-dilated input of a
    transposed conv (``jax.lax._conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = kernel + stride - 2
        before = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = kernel + stride - 2 + max(kernel - stride, 0)
        before = kernel - 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return before, pad_len - before


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: truncated normal of variance 1 / fan_in."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(1.0 / math.sqrt(fan_in) / TRUNC_STD)


def stats_dtype(x: torch.Tensor) -> torch.Tensor:
    """Norm statistics in at least fp32, as Flax computes them."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Conv(nn.Module):
    """Flax ``nn.Conv`` on NCHW: ``groups`` is its ``feature_group_count``;
    ``stride`` may be overridden per call (NASNet's fitting squeeze)."""

    def __init__(self, in_channels: int, features: int, kernel, strides=1,
                 padding: str = "SAME", use_bias: bool = True, groups: int = 1):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.kernel_size, self.strides, self.padding = pair(kernel), pair(strides), padding
        self.groups = groups
        self.kernel = nn.Parameter(torch.empty(features, in_channels // groups,
                                               *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, stride=None) -> torch.Tensor:
        stride = pair(stride) if stride is not None else self.strides
        pad = (0, 0)
        if self.padding == "SAME":
            (t, b), (le, r) = (same_pads(x.shape[2 + d], self.kernel_size[d], stride[d])
                               for d in (0, 1))
            if t == b and le == r:
                pad = (t, le)
            else:
                x = F.pad(x, (le, r, t, b))
        return F.conv2d(x, self.kernel, self.bias, stride, pad, groups=self.groups)


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose`` (no kernel transpose) on NCHW tensors."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        self.stride, self.kernel_size = stride, kernel_size
        before, after = transpose_pads(kernel_size, stride, padding)
        # F.conv_transpose2d pads k - 1 - p on both sides: pad the larger
        # side, crop what the smaller one would not have produced.
        self.conv_padding = kernel_size - 1 - max(before, after)
        if self.conv_padding < 0:
            raise ValueError(f"padding {(before, after)} exceeds kernel {kernel_size}")
        self.crop = (max(after - before, 0), max(before - after, 0))  # (start, end)
        self.kernel = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel[0].numel(), generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.transpose(0, 1).flip(2, 3)
        y = F.conv_transpose2d(x, w, self.bias, self.stride, self.conv_padding)
        start, end = self.crop
        if start or end:
            y = y[:, :, start:y.shape[2] - end, start:y.shape[3] - end]
        return y


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``kernel`` [in, out], ``bias``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel.t(), self.bias)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channels of NCHW tensors (module
    docstring). ``update=True`` in train mode is a Flax call with
    ``use_running_average=False`` and ``batch_stats`` mutable; ``False``
    normalizes with the batch's moments and leaves the buffers."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, update: bool = True) -> torch.Tensor:
        if self.training:
            mean, var = norms.moments(stats_dtype(x), (0, 2, 3), parallel.current_group())
            if update:
                with torch.no_grad():
                    self.mean.copy_(norms.update_moving(self.mean, mean, self.momentum))
                    self.var.copy_(norms.update_moving(self.var, var, self.momentum))
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``: each pixel's channels normalized (the NHWC
    last axis)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = norms.moments(stats_dtype(x), (1,))
        mul = torch.rsqrt(var + self.epsilon)[:, None] * self.scale[:, None, None]
        return (x - mean[:, None]) * mul + self.bias[:, None, None]


class InstanceNorm(nn.Module):
    """CycleGAN's instance norm over NCHW tensors: per-sample spatial
    moments, ``(x - mean) * rsqrt(var + eps) * scale + bias``."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = norms.instance_moments(x, nchw=True)
        return norms.normalize(x, mean, var, self.scale[:, None, None],
                               self.bias[:, None, None], eps=self.epsilon)


PLAIN_LAYERS = (Conv, ConvTranspose, Dense, BatchNorm, LayerNorm, InstanceNorm)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every layer's parameters of ``module`` from ``generator``."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
