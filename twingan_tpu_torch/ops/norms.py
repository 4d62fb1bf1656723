"""Functional normalization cores used at inference.

Counterpart of the eval-time part of ``twingan_tpu/ops/norms.py``: batch
moments, instance moments and the normalize step. Moving-statistic updates
and batch renorm belong to the training slice.
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
