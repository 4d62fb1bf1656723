"""Train state and its update helpers.

Counterpart of ``twingan_tpu/train/state.py``. The JAX ``GanTrainState`` is
an immutable pytree of counters, parameter trees and optimizer states; here
the networks (``nn.ModuleDict`` keyed by network name, parameters and
moving statistics together) and the two ``Optimizer`` objects are updated
in place, and the state object carries them with the counters:

- ``step``: the global step, advanced by each generator update;
- ``critic_step``: every update, generator and discriminator;
- ``gdrop_strength`` and ``gen_loss_ema``: the gdrop schedule's state;
- ``gen_ema_params``: the Polyak average of the generator-side parameters
  (None unless ``moving_average_decay``), keyed like ``state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn


@dataclasses.dataclass
class GanTrainState:
    nets: nn.ModuleDict
    gen_opt: Any
    dis_opt: Any
    gdrop_strength: torch.Tensor
    gen_loss_ema: torch.Tensor
    step: int = 0
    critic_step: int = 0
    gen_ema_params: Optional[dict[str, torch.Tensor]] = None


def update_gdrop_state(state_ema: torch.Tensor, gen_loss: torch.Tensor, step: int, coef: float,
                       lim: float, exp: float,
                       ema_decay: float = 0.9) -> tuple[torch.Tensor, torch.Tensor]:
    """(new loss EMA, gdrop strength) as 0-dim fp32 tensors on the loss's
    device (no host sync): after step 100 the strength is
    coef * max(clip(loss, 0, 1) - lim, 0) ** exp, from the raw clipped loss;
    the EMA is kept but never read, as in the JAX package and its TF
    original."""
    cur = torch.clamp(gen_loss.detach().float(), 0.0, 1.0)
    new_ema = state_ema * ema_decay + cur * (1.0 - ema_decay)
    gdrop_coef = coef if step > 100 else 0.0
    return new_ema, gdrop_coef * torch.pow(torch.clamp(cur - lim, min=0.0), exp)


@torch.no_grad()
def polyak_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
                  decay: float) -> None:
    """ema <- ema * decay + param * (1 - decay), in place, key by key."""
    for k, e in ema_params.items():
        e.mul_(decay).add_(params[k].detach(), alpha=1.0 - decay)
