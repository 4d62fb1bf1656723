"""GAN loss configuration (the loss functions belong to the training slice).

A copy of ``GanLossConfig`` from ``twingan_tpu/train/losses.py`` with the
same fields, defaults and validation, so the JAX ``config.json`` loads.
"""

from __future__ import annotations

import dataclasses

ARCHITECTURES = ("gan", "dragan", "wgan", "wgan_gp", "hinge")


@dataclasses.dataclass(frozen=True)
class GanLossConfig:
    architecture: str = "dragan"
    gan_weight: float = 1.0
    gradient_penalty_lambda: float = 10.0
    wgan_drift_loss_weight: float = 0.0

    def __post_init__(self):
        if self.architecture not in ARCHITECTURES:
            raise ValueError(f"unsupported loss architecture {self.architecture!r}")
