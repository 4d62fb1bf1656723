"""Weight bridge between the JAX package's Flax trees and the port.

A Flax ``params`` tree and its ``batch_stats``, ``spectral`` and ``quant``
collections, given as nested dicts of numpy arrays (``jax.device_get`` of
the JAX state), become a PyTorch ``state_dict`` and back, for one network
or for a whole train state (``params``/``model_state`` keyed by network
name):

- the key is the Flax path joined with dots (``block_64_conv0.conv.kernel``,
  ``block_64_conv0.norm.gamma_1``, ``self_attention_64.sa_gamma``);
  ``batch_stats`` leaves (``moving_mean_%d``/``moving_var_%d`` and batch
  renorm's ``renorm_mean_%d``, ``renorm_stddev_%d`` and their 0-d
  ``*_weight_%d``), the ``spectral`` collection's ``u`` (which the port
  cannot redraw from JAX's PRNG, so the bridge carries it) and the
  ``quant`` collection's ``a_max`` (an int8 calibration's abs-maxima, so
  that calibrated stages cross both ways) are buffers under the same path;
- conv kernels are HWIO in Flax and OIHW in PyTorch; dense kernels,
  the conditional norms' ``*_fc_kernel_%d`` included, keep the Flax
  [in, out] layout;
- every other leaf is copied as it is.

A whole train state, of either trainer, crosses through the flat state
dict of ``train.state.state_to_dict``, whose keys are the JAX state dict's
paths: ``flat_from_flax`` flattens a JAX state (or an Orbax restore of
one) as ``flax.serialization.to_state_dict`` would, without importing
flax or optax, and ``torch_flat``/``flax_flat`` convert its leaves'
layout. ``state_from_flax`` and its inverse ``flax_state_dict`` carry
every field: the networks' parameters and moving statistics, both
optimizers' update counts and slots (Adam's mu and nu, momentum's trace,
and the slots of rmsprop, adagrad, adadelta and ftrl at optax's paths),
the counters, the gdrop state and the Polyak average. A TwinGAN state
with the style embedding or distillation carries ``encoder_style`` and
``distill_s``/``distill_t`` as it carries the other networks.
``twingan_state_from_flax``/``flax_from_twingan_state`` carry a TwinGAN
state's networks only, with fresh optimizers.

A classifier of the zoo (``models/classifiers.py``) crosses the same way,
its conv kernels HWIO <-> OIHW and its dense kernels [in, out] on both
sides (``classifier_state_dict_from_flax`` for one network's ``params``
and ``batch_stats``, and its inverse). A whole
``ClassifierTrainer`` state (the step, ``params``, ``model_state/
batch_stats`` and the optimizer's counts and slots) crosses through
``classifier_state_from_flax`` and ``flax_classifier_state_dict``.

The conversion is exact both ways. Imports numpy and torch only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from twingan_tpu_torch.train.state import (
    GanTrainState,
    collection,
    state_from_dict,
    state_to_dict,
)
from twingan_tpu_torch.train.twingan_trainer import ENC, ENC_STYLE, GEN, TwinGANTrainer

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
                         prefix: str = "",
                         spectral: Mapping[str, Any] | None = None,
                         quant: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """One Flax module's ``params`` (+ ``batch_stats``, ``spectral``,
    ``quant``) -> state_dict."""
    sd = {}
    flat = _flatten(params)
    for group in (batch_stats, spectral, quant):
        flat.update(_flatten(group or {}))
    for key, arr in flat.items():
        if _is_conv_kernel(key, arr):
            arr = arr.transpose(_HWIO_TO_OIHW)
        sd[prefix + key] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd


def flax_variables(state_dict: Mapping[str, torch.Tensor], prefix: str = "") -> dict:
    """Inverse of ``state_dict_from_flax``: -> the Flax variables
    ``{"params": ..., "batch_stats": ..., "spectral": ..., "quant": ...}``,
    each collection present when it has a leaf (``params`` always)."""
    groups: dict[str, dict] = {"params": {}}
    for key, t in state_dict.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        arr = t.detach().cpu().numpy()
        if _is_conv_kernel(key, arr):
            arr = np.ascontiguousarray(arr.transpose(_OIHW_TO_HWIO))
        groups.setdefault(collection(key.rsplit(".", 1)[-1]), {})[key] = arr
    return {k: _unflatten(v) for k, v in groups.items()}


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                         prefix: str = "") -> tuple[dict, dict]:
    """``flax_variables`` as (params, batch_stats), for networks without a
    spectral norm."""
    variables = flax_variables(state_dict, prefix)
    return variables["params"], variables.get("batch_stats", {})


def train_state_dict(params: Mapping[str, Any], model_state: Mapping[str, Any],
                     names: tuple[str, ...] | None = None) -> dict[str, torch.Tensor]:
    """A JAX train state's networks (all of ``params``, or ``names``) ->
    one state_dict with the network name as the key prefix."""
    sd = {}
    for name in names or tuple(params):
        state = model_state.get(name, {})
        sd.update(state_dict_from_flax(params[name], state.get("batch_stats"), name + ".",
                                       state.get("spectral"), state.get("quant")))
    return sd


def flax_train_state(state_dict: Mapping[str, torch.Tensor],
                     names: tuple[str, ...]) -> tuple[dict, dict]:
    """Inverse of ``train_state_dict``: -> (params, model_state) keyed by
    network name, a network's ``model_state`` holding ``batch_stats``,
    ``spectral`` and ``quant`` where it has such leaves, as the JAX
    state's."""
    params, model_state = {}, {}
    for name in names:
        variables = flax_variables(state_dict, prefix=name + ".")
        params[name] = variables.pop("params")
        model_state[name] = variables
    return params, model_state


def translator_state_dict(params: Mapping[str, Any],
                          model_state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX TwinGAN state's encoder and generator (and style encoder,
    where the state has one) -> the state_dict of ``TwinGANTranslator``.
    ``params``/``model_state`` are the trainer state's dicts (pass the
    Polyak-averaged params for an EMA model)."""
    return train_state_dict(params, model_state,
                            (ENC, GEN) + ((ENC_STYLE,) if ENC_STYLE in params else ()))


def flat_from_flax(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """A JAX state with numpy leaves (``jax.device_get``), or the nested
    dict of an Orbax restore, flattened as ``flax.serialization.
    to_state_dict`` lays it out: dataclass fields, dict keys, NamedTuple
    fields and tuple indices joined with ``/``; None and empty states leave
    nothing."""
    if tree is None:
        return {}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, Mapping):
        items = list(tree.items())
    elif hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_from_flax(v, f"{prefix}{k}/"))
    return out


def torch_flat(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX-layout leaves -> the port's tensors (conv kernels HWIO -> OIHW)."""
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if _is_conv_kernel(key, arr):
            arr = arr.transpose(_HWIO_TO_OIHW)
        out[key] = torch.from_numpy(np.array(arr))  # a writable copy
    return out


def flax_flat(flat: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``torch_flat``."""
    out = {}
    for key, t in flat.items():
        arr = t.detach().cpu().numpy()
        out[key] = np.ascontiguousarray(arr.transpose(_OIHW_TO_HWIO)) if _is_conv_kernel(
            key, arr) else arr
    return out


def state_from_flax(trainer, jax_state: Any) -> GanTrainState:
    """A whole JAX train state (numpy leaves) -> the port's state on the
    trainer's device: networks, optimizer counts and slots, counters and
    Polyak average."""
    state = trainer.state_from_nets(trainer.build_nets())
    return state_from_dict(state, torch_flat(flat_from_flax(jax_state)))


def flax_state_dict(state: GanTrainState) -> dict:
    """Inverse of ``state_from_flax``: the nested JAX state dict (numpy
    leaves), as ``flax.serialization.to_state_dict`` of the JAX state;
    ``flax.serialization.from_state_dict`` loads it into a JAX template.
    Every network has its ``model_state`` entry, empty for a network
    without statistics (a CycleGAN's), and a state without a Polyak average
    has ``gen_ema_params`` None, as the JAX state has."""
    tree: dict = {"model_state": {name: {} for name in state.nets}}
    if state.gen_ema_params is None:
        tree["gen_ema_params"] = None
    for key, arr in flax_flat(state_to_dict(state)).items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def twingan_state_from_flax(trainer: TwinGANTrainer, params: Mapping[str, Any],
                            model_state: Mapping[str, Any], step: int = 0,
                            critic_step: int = 0) -> GanTrainState:
    """A JAX TwinGAN state's four networks -> a port state on the trainer's
    device, with fresh optimizers (as ``init_state`` has) and the counters
    given. ``state_from_flax`` carries the whole state."""
    nets = trainer.build_nets()
    nets.load_state_dict(train_state_dict(params, model_state, tuple(nets.keys())),
                         strict=True)
    return trainer.state_from_nets(nets, step=step, critic_step=critic_step)


def flax_from_twingan_state(state: GanTrainState) -> tuple[dict, dict]:
    """Inverse of ``twingan_state_from_flax``: the networks as the JAX
    (params, model_state)."""
    return flax_train_state(state.nets.state_dict(), tuple(state.nets.keys()))


def _classifier_leaf(key: str, arr: np.ndarray, to_torch: bool) -> np.ndarray:
    """A classifier leaf's layout change: conv kernels HWIO <-> OIHW (a
    depthwise (kh, kw, 1, C) <-> (C, 1, kh, kw)); dense kernels keep Flax's
    [in, out]. Optimizer slots follow their parameter's path, so they
    change too."""
    if _is_conv_kernel(key, arr):
        return arr.transpose(_HWIO_TO_OIHW if to_torch else _OIHW_TO_HWIO)
    return arr


def classifier_torch_flat(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX-layout classifier leaves (any key separator) -> the port's tensors."""
    return {k: torch.from_numpy(np.array(_classifier_leaf(k, np.asarray(v), True)))
            for k, v in flat.items()}


def classifier_flax_flat(flat: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``classifier_torch_flat``."""
    return {k: np.array(_classifier_leaf(k, t.detach().cpu().numpy(), False), order="C")
            for k, t in flat.items()}


def classifier_state_dict_from_flax(params: Mapping[str, Any],
                                    batch_stats: Mapping[str, Any] | None = None
                                    ) -> dict[str, torch.Tensor]:
    """One Flax classifier's ``params`` (+ ``batch_stats``) -> the port
    network's ``state_dict`` (the Flax paths joined with dots)."""
    flat = _flatten(params)
    flat.update(_flatten(batch_stats or {}))
    return classifier_torch_flat(flat)


def flax_from_classifier_state_dict(state_dict: Mapping[str, torch.Tensor]
                                    ) -> tuple[dict, dict]:
    """Inverse of ``classifier_state_dict_from_flax``: (params,
    batch_stats) as nested dicts of numpy arrays."""
    from twingan_tpu_torch.train.classifier_trainer import STATS_LEAVES

    params, stats = {}, {}
    for key, arr in classifier_flax_flat(state_dict).items():
        (stats if key.rsplit(".", 1)[-1] in STATS_LEAVES else params)[key] = arr
    return _unflatten(params), _unflatten(stats)


def classifier_state_from_flax(trainer, jax_state: Any):
    """A whole ``ClassifierTrainer`` state of the JAX package (numpy
    leaves, or the nested dict of an Orbax restore) -> the port's
    ``ClassifierState`` on the trainer's device: the network's parameters
    and moving statistics, the optimizer's count and slots, the step."""
    from twingan_tpu_torch.train.classifier_trainer import classifier_state_from_dict

    state = trainer.init_state(0)
    return classifier_state_from_dict(state, classifier_torch_flat(flat_from_flax(jax_state)))


def flax_classifier_state_dict(state) -> dict:
    """Inverse of ``classifier_state_from_flax``: the nested JAX state dict
    (numpy leaves), every leaf of ``flax.serialization.to_state_dict`` of
    the JAX ``ClassifierState`` at its path (the optimizer's empty states,
    which have no leaf, are left out)."""
    from twingan_tpu_torch.train.classifier_trainer import classifier_state_to_dict

    tree: dict = {}
    for key, arr in classifier_flax_flat(classifier_state_to_dict(state)).items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree
