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
gradient). ``rmsprop``, ``adagrad``, ``adadelta`` and ``ftrl`` are hand
updates (``HAND_UPDATES``), each the optax chain the JAX factory builds,
line for line:

- rmsprop: nu = (1 - decay) g^2 + decay nu; u = -lr g / sqrt(nu + eps)
  (optax puts eps inside the root, ``torch.optim`` outside it); then the
  momentum trace t = u + momentum t, which is the update;
- adagrad: s = g^2 + s from ``adagrad_initial_accumulator_value``;
  u = -lr g / sqrt(s + 1e-7) (0 where s is 0);
- adadelta: e_g = (1 - rho) g^2 + rho e_g; d = sqrt(e_x + eps) /
  sqrt(e_g + eps) g; e_x = (1 - rho) d^2 + rho e_x; u = -lr d;
- ftrl: the JAX package's FTRL-Proximal (``train/optimizers.py:ftrl``),
  the new weight a closed form of the accumulated (accum, linear).

Their slots advance for every parameter, frozen ones included, and a frozen
parameter never moves, as under optax's masked updates after the chain.

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

TORCH_OPTIMIZERS = ("adam", "sgd", "momentum")
HAND_UPDATES = ("rmsprop", "adagrad", "adadelta", "ftrl")
# Each torch.optim optimizer's per-parameter state: optax's field name ->
# torch.optim's.
SLOTS = {"adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
         "momentum": {"trace": "momentum_buffer"}, "sgd": {}}
# Where each optimizer's optax chain keeps its update count and its slots,
# before the prefixes of weight decay, clipping and frozen scopes.
_STATE_PATHS = {
    "adam": (("0/count", "1/count"), {"mu": "0/mu", "nu": "0/nu"}),
    "momentum": (("1/count",), {"trace": "0/trace"}),
    "sgd": (("1/count",), {}),
    # ScaleByRmsState(nu), ScaleByScheduleState(count), TraceState(trace).
    "rmsprop": (("1/count",), {"nu": "0/nu", "trace": "2/trace"}),
    # ScaleByRssState(sum_of_squares), ScaleByScheduleState(count).
    "adagrad": (("1/count",), {"sum_of_squares": "0/sum_of_squares"}),
    # optax.adadelta chains an (empty) add_decayed_weights state first.
    "adadelta": (("2/count",), {"e_g": "1/e_g", "e_x": "1/e_x"}),
    # The JAX package's FtrlState(count, accum, linear), not a chain.
    "ftrl": (("count",), {"accum": "accum", "linear": "linear"}),
}
ADAGRAD_EPS = 1e-7  # optax.adagrad's default; the JAX factory passes none


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
    a masked empty state after it. The hand updates keep optax's layouts
    (``_STATE_PATHS``)."""
    counts, slots = _STATE_PATHS[cfg.optimizer]
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
        if cfg.optimizer not in TORCH_OPTIMIZERS + HAND_UPDATES:
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
        self.opt = None
        self.hand: dict[str, list[torch.Tensor]] = {}
        if cfg.optimizer in HAND_UPDATES:
            self.hand = {slot: [torch.full_like(p, self._slot_init(slot)) for p in self.params]
                         for slot in _STATE_PATHS[cfg.optimizer][1]}
            return
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

    def _slot_init(self, slot: str) -> float:
        """A hand update's slot at init: optax's initial accumulators."""
        if slot == "sum_of_squares":
            return self.cfg.adagrad_initial_accumulator_value
        if slot == "accum":
            return self.cfg.ftrl_initial_accumulator_value
        return 0.0

    def slots(self) -> dict[str, dict[str, torch.Tensor]]:
        """The per-parameter state under optax's names (``{"mu": {name:
        tensor}, "nu": ...}`` for adam). For ``torch.optim`` zeros where it
        holds none: frozen parameters, and every parameter before the first
        update."""
        if self.hand:
            return {slot: {name: t.detach().clone() for name, t in zip(self.names, tensors)}
                    for slot, tensors in self.hand.items()}
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
        ``slots``. ``torch.optim`` keeps none for frozen parameters (they
        never move)."""
        self.count = int(count)
        if self.hand:
            for slot, tensors in self.hand.items():
                for t, name in zip(tensors, self.names):
                    t.copy_(slots[slot][name])
            return
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
        grads = [g.to(torch.promote_types(g.dtype, torch.float32)) for g in grads]
        if cfg.clip_global_norm:
            norm = float(global_norm(grads))
            if not norm < cfg.clip_global_norm:
                grads = [g * (cfg.clip_global_norm / norm) for g in grads]
        if self.hand:
            lr = self.schedule(self.count)
            for i, (p, g, t) in enumerate(zip(self.params, grads, self.trainable)):
                if cfg.weight_decay:
                    g = g + cfg.weight_decay * p
                update = self._hand_update(i, g, p, lr)
                if t:
                    p.add_(update)
            self.count += 1
            return
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

    def _hand_update(self, i: int, g: torch.Tensor, w: torch.Tensor, lr: float) -> torch.Tensor:
        """Parameter ``i``'s update from gradient ``g`` at learning rate
        ``lr``, its slots advanced in place."""
        cfg, s = self.cfg, {k: v[i] for k, v in self.hand.items()}
        name = cfg.optimizer
        if name == "rmsprop":
            decay = cfg.rmsprop_decay
            s["nu"].copy_((1 - decay) * g ** 2 + decay * s["nu"])
            u = -lr * (torch.rsqrt(s["nu"] + cfg.opt_epsilon) * g)
            s["trace"].copy_(u + cfg.rmsprop_momentum * s["trace"])
            return s["trace"].clone()
        if name == "adagrad":
            s["sum_of_squares"].add_(g * g)
            acc = s["sum_of_squares"]
            inv = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS), torch.zeros_like(acc))
            return -lr * (inv * g)
        if name == "adadelta":
            rho, eps = cfg.adadelta_rho, cfg.opt_epsilon
            s["e_g"].copy_((1 - rho) * g ** 2 + rho * s["e_g"])
            d = torch.sqrt(s["e_x"] + eps) / torch.sqrt(s["e_g"] + eps) * g
            s["e_x"].copy_((1 - rho) * d ** 2 + rho * s["e_x"])
            return -lr * d
        # ftrl, with tf.train.FtrlOptimizer's semantics (p = -lr_power).
        p = -cfg.ftrl_learning_rate_power
        a, lin = s["accum"], s["linear"]
        a_new = a + g * g
        sigma = (a_new ** p - a ** p) / lr
        lin.copy_(lin + g - sigma * w)
        quad = a_new ** p / lr + 2.0 * cfg.ftrl_l2
        l1 = cfg.ftrl_l1
        w_new = torch.where(lin.abs() > l1, (torch.sign(lin) * l1 - lin) / quad,
                            torch.zeros_like(w))
        a.copy_(a_new)
        return w_new - w


def build_optimizer(cfg: OptimizerConfig, params: Mapping[str, torch.nn.Parameter],
                    updates_per_step: int = 1) -> Optimizer:
    return Optimizer(cfg, params, updates_per_step)
