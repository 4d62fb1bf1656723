"""Stage checkpoints of the port: ``config.json`` + ``model.pt``.

Counterpart of ``twingan_tpu/runner/checkpoint.py`` for serving. A stage
directory holds the config snapshot in the JAX runner's JSON schema
(``{"run": ..., "trainer": ...}``) and ``model.pt``, a ``torch.save`` of
``{"step": int, "state_dict": TwinGANTranslator.state_dict()}``. Orbax
checkpoints of the JAX package become such a directory through
``bridge.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import torch

MODEL_FILE = "model.pt"


def _jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    return obj


def save_stage(stage_dir: str, trainer_cfg: Any, state_dict: Mapping[str, torch.Tensor],
               step: int = 0, run: Mapping[str, Any] | None = None) -> str:
    """Write ``config.json`` (the JAX runner's schema) and ``model.pt``
    into ``stage_dir``."""
    os.makedirs(stage_dir, exist_ok=True)
    with open(os.path.join(stage_dir, "config.json"), "w") as f:
        json.dump(_jsonable({"run": dict(run or {}), "trainer": trainer_cfg}), f,
                  indent=2, default=str)
    path = os.path.join(stage_dir, MODEL_FILE)
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"step": int(step), "state_dict": cpu}, path)
    return path


def load_model(stage_dir: str) -> tuple[dict, int]:
    """(state_dict on the CPU, step) from ``stage_dir/model.pt``."""
    path = os.path.join(stage_dir, MODEL_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {MODEL_FILE} in {stage_dir}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob["state_dict"], int(blob["step"])
