"""Weight bridge between the JAX package's Flax trees and the port.

A Flax ``params`` tree and its ``batch_stats`` collection, given as nested
dicts of numpy arrays (``jax.device_get`` of the JAX state), become a
PyTorch ``state_dict`` and back, for one network or for a whole train
state (``params``/``model_state`` keyed by network name):

- the key is the Flax path joined with dots (``block_64_conv0.conv.kernel``,
  ``block_64_conv0.norm.gamma_1``, ``self_attention_64.sa_gamma``);
  ``batch_stats`` leaves (``moving_mean_%d``/``moving_var_%d``) are buffers
  under the same path;
- conv kernels are HWIO in Flax and OIHW in PyTorch; dense kernels keep
  the Flax [in, out] layout;
- every other leaf is copied as it is.

A GanTrainer (generation) state crosses whole (``gan_state_from_flax`` and
``flax_from_gan_state``): both networks, both optimizers' update counts
and slots (Adam's mu and nu, momentum's trace, in the parameters' layout),
the counters, the gdrop state and the Polyak average. The optax state is
read by its field names (``mu``, ``nu``, ``trace``, ``count``), without
importing optax.

The conversion is exact both ways. Imports numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from twingan_tpu_torch.train import gan_trainer
from twingan_tpu_torch.train.gan_trainer import GanTrainer
from twingan_tpu_torch.train.optimizers import SLOTS
from twingan_tpu_torch.train.state import GanTrainState
from twingan_tpu_torch.train.twingan_trainer import ENC, GEN, TwinGANTrainer

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _is_conv_kernel(key: str, arr: np.ndarray) -> bool:
    return key.endswith("kernel") and arr.ndim == 4


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] | None = None,
                         prefix: str = "") -> dict[str, torch.Tensor]:
    """One Flax module's ``params`` (+ ``batch_stats``) -> state_dict."""
    sd = {}
    flat = _flatten(params)
    flat.update(_flatten(batch_stats or {}))
    for key, arr in flat.items():
        if _is_conv_kernel(key, arr):
            arr = arr.transpose(_HWIO_TO_OIHW)
        sd[prefix + key] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                         prefix: str = "") -> tuple[dict, dict]:
    """Inverse of ``state_dict_from_flax``: -> (params, batch_stats)."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        arr = t.detach().cpu().numpy()
        if _is_conv_kernel(key, arr):
            arr = np.ascontiguousarray(arr.transpose(_OIHW_TO_HWIO))
        leaf = key.rsplit(".", 1)[-1]
        (stats if leaf.startswith(("moving_mean_", "moving_var_")) else params)[key] = arr
    return _unflatten(params), _unflatten(stats)


def train_state_dict(params: Mapping[str, Any], model_state: Mapping[str, Any],
                     names: tuple[str, ...] | None = None) -> dict[str, torch.Tensor]:
    """A JAX train state's networks (all of ``params``, or ``names``) ->
    one state_dict with the network name as the key prefix."""
    sd = {}
    for name in names or tuple(params):
        stats = model_state.get(name, {}).get("batch_stats")
        sd.update(state_dict_from_flax(params[name], stats, prefix=name + "."))
    return sd


def flax_train_state(state_dict: Mapping[str, torch.Tensor],
                     names: tuple[str, ...]) -> tuple[dict, dict]:
    """Inverse of ``train_state_dict``: -> (params, model_state) keyed by
    network name, a network's ``model_state`` holding ``batch_stats`` when it
    has moving statistics and empty otherwise, as the JAX state's."""
    params, model_state = {}, {}
    for name in names:
        params[name], stats = flax_from_state_dict(state_dict, prefix=name + ".")
        model_state[name] = {"batch_stats": stats} if stats else {}
    return params, model_state


def translator_state_dict(params: Mapping[str, Any],
                          model_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX TwinGAN state's encoder and generator -> the state_dict of
    ``TwinGANTranslator``. ``params``/``model_state`` are the trainer
    state's dicts (pass the Polyak-averaged params for an EMA model)."""
    return train_state_dict(params, model_state, (ENC, GEN))


def twingan_state_from_flax(trainer: TwinGANTrainer, params: Mapping[str, Any],
                            model_state: Mapping[str, Any], step: int = 0,
                            critic_step: int = 0) -> GanTrainState:
    """A port train state holding a JAX TwinGAN state's four networks, on
    the trainer's device, with fresh optimizers (as ``init_state`` has)."""
    nets = trainer.build_nets()
    nets.load_state_dict(train_state_dict(params, model_state, tuple(nets.keys())),
                         strict=True)
    return trainer.state_from_nets(nets, step=step, critic_step=critic_step)


def flax_from_twingan_state(state: GanTrainState) -> tuple[dict, dict]:
    """A port TwinGAN state's networks -> the JAX (params, model_state)."""
    return flax_train_state(state.nets.state_dict(), tuple(state.nets.keys()))


GAN_NETS = (gan_trainer.GEN, gan_trainer.DIS)


def _optax_slots(opt_state: Any) -> tuple[int, dict]:
    """(update count, {slot: param tree}) of an optax state: the first
    ``count`` field met and every ``mu``/``nu``/``trace`` field, through
    the nested tuples and NamedTuples of a chain."""
    found: dict = {}

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is None:
            if isinstance(node, (tuple, list)):
                for v in node:
                    walk(v)
            return
        for f in fields:
            v = getattr(node, f)
            if f == "count":
                found.setdefault("count", int(np.asarray(v)))
            elif f in ("mu", "nu", "trace"):
                found.setdefault("slots", {})[f] = v
            else:
                walk(v)

    walk(opt_state)
    if "count" not in found:
        raise ValueError("no update count in the optimizer state")
    return found["count"], found.get("slots", {})


def gan_state_from_flax(trainer: GanTrainer, jax_state: Any) -> GanTrainState:
    """A JAX ``GanTrainState`` with numpy leaves (``jax.device_get``) -> the
    port's state on the trainer's device, every field carried."""
    nets = trainer.build_nets()
    nets.load_state_dict(train_state_dict(jax_state.params, jax_state.model_state, GAN_NETS),
                         strict=True)
    state = trainer.state_from_nets(nets, step=int(jax_state.step),
                                    critic_step=int(jax_state.critic_step))
    for opt, opt_state in ((state.gen_opt, jax_state.gen_opt_state),
                           (state.dis_opt, jax_state.dis_opt_state)):
        count, slots = _optax_slots(opt_state)
        if set(slots) != set(SLOTS[opt.cfg.optimizer]):
            raise ValueError(f"optimizer state holds {sorted(slots)}, "
                             f"{opt.cfg.optimizer} needs {sorted(SLOTS[opt.cfg.optimizer])}")
        opt.load_slots(count, {k: state_dict_from_flax(tree) for k, tree in slots.items()})
    device = trainer.device
    state.gdrop_strength = torch.tensor(float(jax_state.gdrop_strength), device=device)
    state.gen_loss_ema = torch.tensor(float(jax_state.gen_loss_ema), device=device)
    if jax_state.gen_ema_params is not None:
        state.gen_ema_params = {k: v.to(device)
                                for k, v in state_dict_from_flax(jax_state.gen_ema_params).items()}
    return state


def flax_from_gan_state(state: GanTrainState) -> dict[str, Any]:
    """Inverse of ``gan_state_from_flax``: the JAX state's fields as a dict
    of numpy trees; each optimizer state as ``{"count": int, slot: tree}``
    (zeros for the frozen parameters, which the port keeps no slots for)."""
    params, model_state = flax_train_state(state.nets.state_dict(), GAN_NETS)
    out = {"step": state.step, "critic_step": state.critic_step, "params": params,
           "model_state": model_state,
           "gdrop_strength": np.float32(float(state.gdrop_strength)),
           "gen_loss_ema": np.float32(float(state.gen_loss_ema)),
           "gen_ema_params": (None if state.gen_ema_params is None
                              else flax_from_state_dict(state.gen_ema_params)[0])}
    for side, opt in (("gen_opt_state", state.gen_opt), ("dis_opt_state", state.dis_opt)):
        out[side] = {"count": opt.count, **{k: flax_from_state_dict(sd)[0]
                                            for k, sd in opt.slots().items()}}
    return out
