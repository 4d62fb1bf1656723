"""Config (de)serialization: typed configs from a stage's config.json.

Counterpart of ``twingan_tpu/runner/config_io.py``. The JSON schema is the
JAX runner's (``{"run": {...}, "trainer": {...}}``), so a stage directory
written by either package loads here: a TwinGAN trainer config (told
apart by its ``l_cyc_weight`` field, as the JAX reader does) or a
GanTrainer (generation) config. ``run_config_from_dict`` rebuilds the
typed ``RunConfig`` from the ``run`` dict (JSON turns its tuples into
lists and its schedules' integer keys into strings); the inverse is
``runner.checkpoint.save_config_snapshot``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from twingan_tpu_torch.models.config import PGGANConfig
from twingan_tpu_torch.runner.checkpoint import MODEL_FILE
from twingan_tpu_torch.runner.stage_runner import RunConfig
from twingan_tpu_torch.train.gan_trainer import GanTrainerConfig
from twingan_tpu_torch.train.losses import GanLossConfig
from twingan_tpu_torch.train.optimizers import OptimizerConfig
from twingan_tpu_torch.train.twingan_trainer import TwinGANConfig


def _build(cls, data: dict) -> Any:
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            continue
        if k == "model":
            v = _build(PGGANConfig, v)
        elif k == "loss":
            v = _build(GanLossConfig, v)
        elif k == "opt":
            v = _build(OptimizerConfig, v)
            v = v.replace(frozen_scopes=tuple(v.frozen_scopes))
        kwargs[k] = v
    return cls(**kwargs)


def trainer_config_from_dict(data: dict) -> TwinGANConfig | GanTrainerConfig:
    cls = TwinGANConfig if "l_cyc_weight" in data else GanTrainerConfig
    return _build(cls, data)


def run_config_from_dict(data: dict, trainer: Any = None) -> RunConfig:
    """The typed ``RunConfig`` of a ``run`` dict, with ``trainer``."""
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    kwargs = {k: v for k, v in data.items() if k in fields and k != "trainer"}
    for k in ("num_images_schedule", "batch_schedule"):
        if kwargs.get(k) is not None:
            kwargs[k] = {int(r): int(v) for r, v in kwargs[k].items()}
    if "checkpoint_exclude_scopes" in kwargs:
        kwargs["checkpoint_exclude_scopes"] = tuple(kwargs["checkpoint_exclude_scopes"])
    return RunConfig(trainer=trainer, **kwargs)


def load_stage_config(stage_dir: str):
    """Reads a stage dir's config.json -> (run dict, trainer_config);
    ``run_config_from_dict(run, trainer_config)`` types the run dict."""
    with open(os.path.join(stage_dir, "config.json")) as f:
        data = json.load(f)
    return data.get("run", {}), trainer_config_from_dict(data["trainer"])


def find_latest_stage_dir(train_dir: str) -> str:
    """The most advanced stage dir holding a port checkpoint: the largest
    resolution, the stable stage ahead of the growing one ("128to256")."""
    candidates = []
    for name in os.listdir(train_dir):
        full = os.path.join(train_dir, name)
        if not os.path.isfile(os.path.join(full, MODEL_FILE)):
            continue
        if name.isdigit():
            candidates.append((int(name), 1, full))
        elif "to" in name:
            try:
                res = int(name.split("to")[1])
            except ValueError:
                continue
            candidates.append((res, 0, full))
    if not candidates:
        raise FileNotFoundError(f"no stage checkpoints under {train_dir}")
    return sorted(candidates)[-1][2]
