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

``state_to_dict`` and ``state_from_dict`` are the port's
``flax.serialization.to_state_dict``/``from_state_dict``: the whole state
as one flat dict whose keys are the JAX state dict's paths joined with
``/`` (``params/<net>/...``, ``model_state/<net>/batch_stats/...`` for the
moving statistics and batch renorm's state, ``model_state/<net>/spectral/
.../u`` for the spectral norms' vectors, ``gen_opt_state/0/mu/...`` as
optax lays the chain out, the four counters,
``gen_ema_params/...``) and whose values are the port's tensors (conv
kernels OIHW). Checkpoints, migration and the bridge work on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

from twingan_tpu_torch.train.optimizers import state_paths

OPT_SIDES = ("gen_opt_state", "dis_opt_state")


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


BATCH_STATS_PREFIXES = ("moving_mean_", "moving_var_", "renorm_")
# The running moments of a stock Flax ``nn.BatchNorm`` (the alternative
# GANs, ``models/plain_layers.py``).
BATCH_STATS_LEAVES = ("mean", "var")


def collection(leaf: str) -> str:
    """The Flax collection a layer's leaf lives in: ``batch_stats`` for the
    moving statistics, batch renorm's state and a stock batch norm's
    ``mean``/``var``, ``spectral`` for a spectral norm's ``u``, ``quant``
    for an int8 calibration's ``a_max``, else ``params``."""
    if leaf.startswith(BATCH_STATS_PREFIXES) or leaf in BATCH_STATS_LEAVES:
        return "batch_stats"
    return {"u": "spectral", "a_max": "quant"}.get(leaf, "params")


def _jax_path(key: str) -> str:
    """A ``nets.state_dict()`` key -> its path in the JAX state dict."""
    net, rest = key.split(".", 1)
    kind = collection(rest.rsplit(".", 1)[-1])
    group = ("params", net) if kind == "params" else ("model_state", net, kind)
    return "/".join(group + tuple(rest.split(".")))


def _port_key(path: str) -> Optional[str]:
    """Inverse of ``_jax_path``: None for a path outside the networks."""
    parts = path.split("/")
    if parts[0] == "params":
        return ".".join(parts[1:])
    if (parts[0] == "model_state" and len(parts) > 3
            and parts[2] in ("batch_stats", "spectral", "quant")):
        return ".".join([parts[1]] + parts[3:])
    return None


def serving_state_dict(flat, nets: tuple[str, ...],
                       ema_net: Optional[str] = None) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of the networks ``nets`` (``net.path`` keys) from a
    flat train state, with the Polyak average in place of the parameters
    where the state keeps one. ``ema_net`` names the network the average's
    paths are relative to (a generation state's generator); None when they
    start with the network's name (TwinGAN's generator side)."""
    out = {}
    for path, t in flat.items():
        key = _port_key(path)
        if key is not None and key.split(".", 1)[0] in nets:
            out[key] = t
    for path, t in flat.items():
        if path.startswith("gen_ema_params/"):
            key = path[len("gen_ema_params/"):].replace("/", ".")
            key = f"{ema_net}.{key}" if ema_net else key
            if key.split(".", 1)[0] in nets:
                out[key] = t
    return out


def _opts(state: GanTrainState):
    return zip(OPT_SIDES, (state.gen_opt, state.dis_opt))


def state_to_dict(state: GanTrainState) -> dict[str, torch.Tensor]:
    """The whole train state as a flat dict keyed by JAX state-dict paths.
    The networks' tensors are the live ones (detached); the optimizer slots
    and counters are copies."""
    out: dict[str, torch.Tensor] = {}
    for key, t in state.nets.state_dict().items():
        out[_jax_path(key)] = t
    for side, opt in _opts(state):
        counts, slot_paths = state_paths(opt.cfg)
        for path in counts:
            out[f"{side}/{path}"] = torch.tensor(opt.count, dtype=torch.int32)
        for slot, tensors in opt.slots().items():
            for name, t in tensors.items():
                out[f"{side}/{slot_paths[slot]}/{name.replace('.', '/')}"] = t
    out["step"] = torch.tensor(state.step, dtype=torch.int32)
    out["critic_step"] = torch.tensor(state.critic_step, dtype=torch.int32)
    out["gdrop_strength"] = state.gdrop_strength.detach().float()
    out["gen_loss_ema"] = state.gen_loss_ema.detach().float()
    for name, t in (state.gen_ema_params or {}).items():
        out[f"gen_ema_params/{name.replace('.', '/')}"] = t.detach()
    return out


@torch.no_grad()
def state_from_dict(state: GanTrainState, flat) -> GanTrainState:
    """Load a flat dict of ``state_to_dict``'s form into ``state`` in place,
    on the state's device: every key ``state_to_dict(state)`` has must be
    there (a migrated template has them all); others are ignored."""
    sd = state.nets.state_dict()
    state.nets.load_state_dict({k: flat[_jax_path(k)] for k in sd}, strict=True)
    for side, opt in _opts(state):
        counts, slot_paths = state_paths(opt.cfg)
        slots = {slot: {name: flat[f"{side}/{prefix}/{name.replace('.', '/')}"]
                        for name in opt.names}
                 for slot, prefix in slot_paths.items()}
        opt.load_slots(int(flat[f"{side}/{counts[0]}"]), slots)
    state.step = int(flat["step"])
    state.critic_step = int(flat["critic_step"])
    device = state.gdrop_strength.device
    state.gdrop_strength = flat["gdrop_strength"].to(device, torch.float32).clone()
    state.gen_loss_ema = flat["gen_loss_ema"].to(device, torch.float32).clone()
    for name, t in (state.gen_ema_params or {}).items():
        t.copy_(flat[f"gen_ema_params/{name.replace('.', '/')}"])
    return state
