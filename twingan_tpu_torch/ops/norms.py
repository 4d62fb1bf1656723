"""Functional normalization cores.

Counterpart of ``twingan_tpu/ops/norms.py`` for batch and instance norm:
batch moments, per-group batch moments, instance moments, the normalize
step and the moving-statistic update. Batch renorm is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def moments(x: torch.Tensor, axes: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean/variance over ``axes`` in the E[x^2] - E[x]^2 form."""
    mean = torch.mean(x, dim=axes)
    mean_sq = torch.mean(torch.square(x), dim=axes)
    var = torch.clamp(mean_sq - torch.square(mean), min=0)
    return mean, var


def normalize(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    gamma: Optional[torch.Tensor],
    beta: Optional[torch.Tensor],
    eps: float = 1e-3,
) -> torch.Tensor:
    """y = (x - mean) * rsqrt(var + eps) * gamma + beta (broadcast)."""
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def instance_moments(x: torch.Tensor, nchw: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample spatial moments for instance norm, kept as broadcastable
    dims ([B,1,1,C] for NHWC, [B,C,1,1] for NCHW)."""
    dims = (2, 3) if nchw else (1, 2)
    mean = torch.mean(x, dim=dims, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=dims, keepdim=True)
    return mean, var


def group_batch_moments(x: torch.Tensor, num_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Biased batch moments of NCHW ``x`` per contiguous batch group:
    ([G, C] mean, [G, C] variance), the variance as the mean of squared
    deviations. One group is the full-batch moments."""
    b = x.shape[0]
    if b % num_groups:
        raise ValueError(f"batch {b} not divisible by bn_num_groups {num_groups}")
    xg = x.reshape(num_groups, b // num_groups, *x.shape[1:])
    mean = torch.mean(xg, dim=(1, 3, 4))
    var = torch.mean(torch.square(xg - mean[:, None, :, None, None]), dim=(1, 3, 4))
    return mean, var


def update_moving(moving: torch.Tensor, value: torch.Tensor, decay: float) -> torch.Tensor:
    """assign_moving_average without zero-debias: m*decay + v*(1-decay)."""
    return moving * decay + value.to(moving.dtype) * (1 - decay)
