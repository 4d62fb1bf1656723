"""Training summaries: a JSONL metrics log and, where they import,
TensorBoard event files.

Counterpart of ``twingan_tpu/utils/summary.py``. ``metrics.jsonl`` gets one
record per ``scalars`` call, ``{"step", "time", name: value, ...}`` with
the 0-dim values only, as the JAX writer's. Events go through
``torch.utils.tensorboard`` where it imports (it needs the ``tensorboard``
package), as the JAX writer uses TensorFlow's where that imports; without
it ``histograms`` writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np


def _value(v) -> float:
    return float(v.item() if hasattr(v, "item") else v)


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._tb = TBWriter(log_dir)
        except Exception:  # no tensorboard package: the JSONL log alone
            self._tb = None

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: _value(v) for k, v in values.items() if np.ndim(v) == 0})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, global_step=int(step))

    def histograms(self, step: int, values: Mapping[str, np.ndarray]) -> None:
        """Histogram and zero fraction per named tensor."""
        if self._tb is None:
            return
        for k, v in values.items():
            arr = np.asarray(v, np.float32)
            self._tb.add_histogram(k, arr, global_step=int(step))
            self._tb.add_scalar(f"{k}/zero_fraction", float(np.mean(arr == 0.0)),
                                global_step=int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
