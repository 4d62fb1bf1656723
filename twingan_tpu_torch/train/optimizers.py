"""Optimizer configuration (the optimizer factory belongs to the training
slice).

A copy of ``OptimizerConfig`` from ``twingan_tpu/train/optimizers.py`` with
the same fields and defaults, so the JAX ``config.json`` loads.
"""

from __future__ import annotations

import dataclasses


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
