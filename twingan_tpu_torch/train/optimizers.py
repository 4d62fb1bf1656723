"""Optimizer + learning-rate-schedule factory.

Counterpart of ``twingan_tpu/train/optimizers.py``: ``OptimizerConfig``
field for field (so the JAX ``config.json`` loads), the three schedules
(fixed, exponential with staircase, polynomial of power 1), and the chain
the JAX factory builds with optax, applied in the same order:
clip_by_global_norm -> coupled weight decay (wd * param added to the
gradient) -> the optimizer -> frozen scopes (their params never move).

Optimizers: ``adam``, ``sgd`` and ``momentum`` run on ``torch.optim``,
whose update rules are optax's (Adam with bias-corrected moments and eps
outside the root; heavy-ball momentum with the trace starting at the first
gradient). ``rmsprop`` (optax adds eps inside the root, ``torch.optim``
outside it), ``adagrad``, ``adadelta`` and ``ftrl`` are not ported yet.

As in optax, the schedule counts this optimizer's own updates, evaluated
before each one; ``updates_per_step`` stretches it for an optimizer that
updates several times per global step (the discriminator's n_critic - 1).

A frozen scope matches as in the JAX ``freeze_scopes``: as a substring of
the parameter's path in ``jax.tree_util.keystr`` form (``scope_path``),
``['block_4_conv0']['conv']['kernel']`` for ``block_4_conv0.conv.kernel``.
When every parameter is frozen no ``torch.optim`` is built (it refuses an
empty list), the updates are still counted, and nothing moves, as under
optax's masked updates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import torch

PORTED_OPTIMIZERS = ("adam", "sgd", "momentum")
UNPORTED_OPTIMIZERS = ("rmsprop", "adagrad", "adadelta", "ftrl")
# Each optimizer's per-parameter state: optax's field name -> torch.optim's.
SLOTS = {"adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
         "momentum": {"trace": "momentum_buffer"}, "sgd": {}}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "adam"
    learning_rate: float = 0.005
    learning_rate_decay_type: str = "fixed"  # fixed | exponential | polynomial
    learning_rate_decay_factor: float = 0.94
    decay_steps: int = 10000
    end_learning_rate: float = 0.0001
    adam_beta1: float = 0.5
    adam_beta2: float = 0.99
    opt_epsilon: float = 1e-8
    momentum: float = 0.9
    rmsprop_momentum: float = 0.9
    rmsprop_decay: float = 0.9
    adadelta_rho: float = 0.95
    adagrad_initial_accumulator_value: float = 0.1
    ftrl_learning_rate_power: float = -0.5
    ftrl_initial_accumulator_value: float = 0.1
    ftrl_l1: float = 0.0
    ftrl_l2: float = 0.0
    weight_decay: float = 0.0
    clip_global_norm: float = 0.0
    frozen_scopes: tuple = ()

    def replace(self, **kw) -> "OptimizerConfig":
        return dataclasses.replace(self, **kw)


def state_paths(cfg: OptimizerConfig) -> tuple[tuple[str, ...], dict[str, str]]:
    """Where the optax chain the JAX factory builds for ``cfg`` keeps its
    update counts and per-parameter slots, as ``/``-joined paths inside the
    optimizer's state dict: (count paths, {slot: path prefix}). Adam is
    (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)); sgd and
    momentum (EmptyState or TraceState(trace), ScaleByScheduleState(count));
    weight decay and clipping chain an empty state before it, frozen scopes
    a masked empty state after it."""
    if cfg.optimizer == "adam":
        counts, slots = ("0/count", "1/count"), {"mu": "0/mu", "nu": "0/nu"}
    elif cfg.optimizer == "momentum":
        counts, slots = ("1/count",), {"trace": "0/trace"}
    else:
        counts, slots = ("1/count",), {}
    prefix = ""
    if cfg.weight_decay:
        prefix = "1/" + prefix
    if cfg.clip_global_norm:
        prefix = "1/" + prefix
    if cfg.frozen_scopes:
        prefix = "0/" + prefix
    return (tuple(prefix + c for c in counts),
            {k: prefix + v for k, v in slots.items()})


def build_schedule(cfg: OptimizerConfig, updates_per_step: int = 1) -> Callable[[int], float]:
    """The learning rate at update ``count`` (0 for the first update)."""
    r = max(1, updates_per_step)
    kind = cfg.learning_rate_decay_type
    if kind == "fixed":
        return lambda count: cfg.learning_rate
    if kind == "exponential":
        steps = cfg.decay_steps * r
        return lambda count: cfg.learning_rate * cfg.learning_rate_decay_factor ** (count // steps)
    if kind == "polynomial":
        steps = cfg.decay_steps * r

        def polynomial(count: int) -> float:
            frac = 1.0 - min(max(count, 0), steps) / steps
            return (cfg.learning_rate - cfg.end_learning_rate) * frac + cfg.end_learning_rate

        return polynomial
    raise ValueError(f"unsupported decay type {kind!r}")


def scope_path(name: str) -> str:
    """A dotted parameter name in ``jax.tree_util.keystr`` form, the string
    the JAX package's frozen scopes are matched against."""
    return "".join(f"['{p}']" for p in name.split("."))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class Optimizer:
    """One side's optimizer over named parameters. ``step(grads)`` takes the
    gradients in the order of ``names`` and updates the parameters in place.
    """

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.nn.Parameter],
                 updates_per_step: int = 1):
        if cfg.optimizer in UNPORTED_OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r} is not ported to twingan_tpu_torch yet")
        if cfg.optimizer not in PORTED_OPTIMIZERS:
            raise ValueError(f"unsupported optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = build_schedule(cfg, updates_per_step)
        self.count = 0
        self.names = list(params)
        self.params = list(params.values())
        # Frozen params are left out of the optimizer: optax zeroes their
        # updates after it, so they never move either way.
        self.trainable = [not any(s in scope_path(name) for s in cfg.frozen_scopes)
                          for name in self.names]
        train = [p for p, t in zip(self.params, self.trainable) if t]
        lr = cfg.learning_rate
        if not train:
            self.opt = None
        elif cfg.optimizer == "adam":
            self.opt = torch.optim.Adam(train, lr=lr, betas=(cfg.adam_beta1, cfg.adam_beta2),
                                        eps=cfg.opt_epsilon)
        elif cfg.optimizer == "sgd":
            self.opt = torch.optim.SGD(train, lr=lr)
        else:
            self.opt = torch.optim.SGD(train, lr=lr, momentum=cfg.momentum)

    def slots(self) -> dict[str, dict[str, torch.Tensor]]:
        """The per-parameter state under optax's names (``{"mu": {name:
        tensor}, "nu": ...}`` for adam), zeros where torch.optim holds none:
        frozen parameters, and every parameter before the first update."""
        out = {}
        for slot, torch_slot in SLOTS[self.cfg.optimizer].items():
            out[slot] = {}
            for name, p in zip(self.names, self.params):
                held = self.opt.state.get(p, {}) if self.opt is not None else {}
                t = held.get(torch_slot)
                out[slot][name] = torch.zeros_like(p) if t is None else t.detach().clone()
        return out

    @torch.no_grad()
    def load_slots(self, count: int, slots: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Set the update count and the per-parameter state, the inverse of
        ``slots``. Frozen parameters keep none (they never move)."""
        self.count = int(count)
        if self.opt is None:
            return
        for p, name, trainable in zip(self.params, self.names, self.trainable):
            if not trainable:
                continue
            state = {torch_slot: slots[slot][name].to(p.device, p.dtype).clone()
                     for slot, torch_slot in SLOTS[self.cfg.optimizer].items()}
            if self.cfg.optimizer == "adam":
                state["step"] = torch.tensor(float(count), dtype=torch.float32)
            self.opt.state[p] = state

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        cfg = self.cfg
        grads = [g.float() for g in grads]
        if cfg.clip_global_norm:
            norm = float(global_norm(grads))
            if not norm < cfg.clip_global_norm:
                grads = [g * (cfg.clip_global_norm / norm) for g in grads]
        for p, g, t in zip(self.params, grads, self.trainable):
            if t:
                p.grad = g + cfg.weight_decay * p if cfg.weight_decay else g
        if self.opt is not None:
            lr = self.schedule(self.count)
            for group in self.opt.param_groups:
                group["lr"] = lr
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        self.count += 1


def build_optimizer(cfg: OptimizerConfig, params: Mapping[str, torch.nn.Parameter],
                    updates_per_step: int = 1) -> Optimizer:
    return Optimizer(cfg, params, updates_per_step)
