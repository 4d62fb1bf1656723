"""Train-state checkpoints, stage serving files and config snapshots.

Counterpart of ``twingan_tpu/runner/checkpoint.py``. ``CheckpointManager``
keeps step-keyed checkpoints of the whole train state under one stage
directory, ``ckpt-<step>/state.pt``: a ``torch.save`` of the flat dict of
``train.state.state_to_dict`` (JAX state-dict paths, CPU tensors), read
back with ``weights_only=True``. Restoring matches leaves by path and
shape (``runner/migrate.py``), as the JAX manager does, so a new optional
field never orphans a checkpoint, and a resume that carries no parameter
is refused.

Beside the checkpoints a stage directory holds ``config.json``, the config
snapshot in the JAX runner's schema (``{"run": ..., "trainer": ...}``),
and ``model.pt``, the serving unit: a ``torch.save`` of ``{"step": int,
"state_dict": ...}`` with ``TwinGANTranslator.state_dict()`` for a TwinGAN
stage or the generator's (``generator.``-prefixed) for a generation stage.
Orbax checkpoints of the JAX package become such a directory through
``tools/orbax_to_torch_stage.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Callable, Mapping, Optional

import torch

from twingan_tpu_torch import parallel
from twingan_tpu_torch.runner.migrate import migrate_state_dict
from twingan_tpu_torch.train.state import state_from_dict, state_to_dict

MODEL_FILE = "model.pt"
STATE_FILE = "state.pt"
_STEP_RE = re.compile(r"^ckpt-(\d+)$")


class CheckpointManager:
    """Step-keyed train-state checkpoints under one stage directory."""

    def __init__(self, train_dir: str):
        self.train_dir = os.path.abspath(train_dir)
        os.makedirs(self.train_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.train_dir, f"ckpt-{step}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.train_dir):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(os.path.join(self.train_dir, name, STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, keep: int = 3) -> str:
        """Save ``state`` (a ``GanTrainState`` or a flat dict) at ``step``;
        keeps ``keep`` checkpoints (all for keep <= 0), never pruning the
        one just written even when it sorts below the others. Under a
        process group (``parallel.current_group()``) every process calls
        it, the first alone writes and prunes (every process holds the same
        state), and all wait at a barrier after it, so none reads a
        checkpoint that is still being written."""
        path = self._path(step)
        group = parallel.current_group()
        if parallel.rank(group) == 0:
            flat = state if isinstance(state, Mapping) else state_to_dict(state)
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, STATE_FILE + ".tmp")
            torch.save({k: v.detach().cpu() for k, v in flat.items()}, tmp)
            os.replace(tmp, os.path.join(path, STATE_FILE))
            if keep > 0:
                prunable = [s for s in self.all_steps() if s != step]
                for old in prunable[: -(keep - 1)] if keep > 1 else prunable:
                    shutil.rmtree(self._path(old), ignore_errors=True)
        parallel.barrier(group)
        return path

    def restore_dict(self, step: Optional[int] = None) -> Optional[dict]:
        """The raw flat state dict (CPU tensors), or None if no checkpoint
        exists."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self._path(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, template_state: Any, step: Optional[int] = None,
                to_dict: Callable = state_to_dict,
                from_dict: Callable = state_from_dict) -> Optional[Any]:
        """Restore into a fresh template state, in place (same-stage
        resume), matching leaves by path and shape; None if there is no
        checkpoint. Refuses a checkpoint that carries no parameter.
        ``to_dict``/``from_dict`` lay the state out flat and load it back
        (a GAN train state's by default; a classifier's from
        ``train/classifier_trainer.py``)."""
        raw = self.restore_dict(step)
        if raw is None:
            return None
        template = to_dict(template_state)
        merged, report = migrate_state_dict(template, raw, reset_paths=())
        # A resume that carries nothing is a config/checkpoint mismatch:
        # fresh params under a carried step counter would train garbage
        # labelled 'resumed' and prune the good checkpoints.
        if not any(p.startswith("params") for p in report["carried"]):
            raise ValueError(
                f"checkpoint in {self.train_dir} matches no parameter of the "
                "current model (config changed between runs?); refusing a "
                f"silent fresh start. Report: { {k: len(v) for k, v in report.items()} }")
        if report["shape_mismatch"]:
            print(f"[checkpoint] WARNING: {len(report['shape_mismatch'])} "
                  f"leaves shape-mismatched on restore and keep fresh init: "
                  f"{report['shape_mismatch'][:5]}...")
        return from_dict(template_state, merged)


def _jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    return obj


def save_config_snapshot(train_dir: str, config: Any, name: str = "config.json") -> str:
    """Dump the nested config (dataclasses, dicts) as JSON."""
    os.makedirs(train_dir, exist_ok=True)
    path = os.path.join(train_dir, name)
    with open(path, "w") as f:
        json.dump(_jsonable(config), f, indent=2, default=str)
    return path


def save_stage(stage_dir: str, trainer_cfg: Any, state_dict: Mapping[str, torch.Tensor],
               step: int = 0, run: Mapping[str, Any] | None = None) -> str:
    """Write ``config.json`` (the JAX runner's schema) and ``model.pt``
    into ``stage_dir``."""
    save_config_snapshot(stage_dir, {"run": dict(run or {}), "trainer": trainer_cfg})
    return save_model(stage_dir, state_dict, step)


def save_model(stage_dir: str, state_dict: Mapping[str, torch.Tensor], step: int) -> str:
    """Write ``model.pt`` alone, beside a config the runner already wrote."""
    os.makedirs(stage_dir, exist_ok=True)
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
