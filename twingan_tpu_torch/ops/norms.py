"""Functional normalization cores.

Counterpart of ``twingan_tpu/ops/norms.py``: batch moments, per-group
batch moments, instance moments, the normalize step, the moving-statistic
update, and batch renorm (the clipping schedule over the global step, the
r/d correction with its debiased EMAs, and the moving moments those EMAs
imply). ``moments`` and ``group_batch_moments`` take a process group
(``twingan_tpu_torch.parallel``) over whose processes' rows they reduce;
without one they are the single-process moments.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from twingan_tpu_torch.parallel.multihost import all_reduce_mean

# Piecewise-constant batch renorm clipping schedule over the global step
# (which restarts at 0 each growth stage).
RENORM_BOUNDARIES = (10000, 20000, 30000)
RENORM_RMAX = (1.1, 1.5, 2.0, 4.0)
RENORM_RMIN = (0.9, 0.66, 0.5, 0.25)
RENORM_DMAX = (0.1, 0.3, 0.5, 1.0)
RENORM_STATE = ("renorm_mean", "renorm_mean_weight", "renorm_stddev", "renorm_stddev_weight")


def renorm_clipping_schedule(step: int) -> dict[str, float]:
    """rmax/rmin/dmax at the host-int ``step``: ``values[i]`` while
    ``step <= boundaries[i]`` (searchsorted side="left"), as fp32 values."""
    idx = sum(step > b for b in RENORM_BOUNDARIES)

    def pick(values):
        return float(torch.tensor(values[idx], dtype=torch.float32))

    return {"rmax": pick(RENORM_RMAX), "rmin": pick(RENORM_RMIN), "dmax": pick(RENORM_DMAX)}


def last_renorm_clip() -> dict[str, float]:
    """The schedule's last values, the clip of a call that passes none."""
    return {"rmax": RENORM_RMAX[-1], "rmin": RENORM_RMIN[-1], "dmax": RENORM_DMAX[-1]}


def moments(x: torch.Tensor, axes: tuple[int, ...],
            group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean/variance over ``axes`` in the E[x^2] - E[x]^2 form, synced over
    the processes of ``group`` (each holding an equal share of the rows)
    by one all-reduce of the stacked (mean, mean_sq), as the JAX function
    pmeans them over a mesh axis."""
    mean = torch.mean(x, dim=axes)
    mean_sq = torch.mean(torch.square(x), dim=axes)
    if group is not None:
        mean, mean_sq = all_reduce_mean(torch.stack([mean, mean_sq]), group).unbind(0)
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


def group_batch_moments(x: torch.Tensor, num_groups: int = 1,
                        group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Biased batch moments of NCHW ``x`` per contiguous batch group:
    ([G, C] mean, [G, C] variance), the variance as the mean of squared
    deviations. One group is the full-batch moments. With ``group`` (one
    batch group spanning the processes' equal shares of the rows) the mean
    and then the squared deviations' mean are averaged over the processes:
    the moments of the whole batch, as the JAX package's global view takes
    them."""
    b = x.shape[0]
    if b % num_groups:
        raise ValueError(f"batch {b} not divisible by bn_num_groups {num_groups}")
    xg = x.reshape(num_groups, b // num_groups, *x.shape[1:])
    mean = all_reduce_mean(torch.mean(xg, dim=(1, 3, 4)), group)
    var = all_reduce_mean(
        torch.mean(torch.square(xg - mean[:, None, :, None, None]), dim=(1, 3, 4)), group)
    return mean, var


def update_moving(moving: torch.Tensor, value: torch.Tensor, decay: float) -> torch.Tensor:
    """assign_moving_average without zero-debias: m*decay + v*(1-decay)."""
    return moving * decay + value.to(moving.dtype) * (1 - decay)


@torch.no_grad()
def batch_renorm_correction(
    batch_mean: torch.Tensor,
    batch_var: torch.Tensor,
    state: Mapping[str, torch.Tensor],
    clipping: Mapping[str, float],
    momentum: float = 0.99,
    eps: float = 1e-3,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Batch-renorm (r, d) corrections and the advanced renorm state.

    ``state`` holds fp32 ``renorm_mean``, ``renorm_mean_weight`` (0-d),
    ``renorm_stddev`` and ``renorm_stddev_weight`` (0-d): biased EMAs,
    debiased by the weight EMAs. r and d carry no gradient; the caller
    computes ``normalize(x, batch_mean, batch_var) * r + d``. The returned
    state is new tensors: ``state`` is not written."""
    mean = batch_mean.float()
    stddev = torch.sqrt(batch_var.float() + eps)
    mixed_mean = state["renorm_mean"] + (1.0 - state["renorm_mean_weight"]) * mean
    mixed_stddev = state["renorm_stddev"] + (1.0 - state["renorm_stddev_weight"]) * stddev
    r = torch.clamp(stddev / mixed_stddev, clipping["rmin"], clipping["rmax"])
    d = torch.clamp((mean - mixed_mean) / mixed_stddev, -clipping["dmax"], clipping["dmax"])
    decay = momentum
    new_state = {
        "renorm_mean": state["renorm_mean"] * decay + mean * (1 - decay),
        "renorm_mean_weight": state["renorm_mean_weight"] * decay + (1 - decay),
        "renorm_stddev": state["renorm_stddev"] * decay + stddev * (1 - decay),
        "renorm_stddev_weight": state["renorm_stddev_weight"] * decay + (1 - decay),
    }
    return r, d, new_state


def renorm_moving_moments(state: Mapping[str, torch.Tensor],
                          eps: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """The debiased mean and variance the renorm state implies (variance =
    stddev^2 - eps), which the moving statistics track."""
    new_mean = state["renorm_mean"] / state["renorm_mean_weight"]
    new_stddev = state["renorm_stddev"] / state["renorm_stddev_weight"]
    return new_mean, torch.square(new_stddev) - eps
