"""Input sources for training.

Counterpart of ``twingan_tpu/data/pipeline.py``, so far its synthetic
source alone: ``SyntheticSource`` yields the same arrays as the JAX one for
the same seed, keys and ``num_classes`` (numpy's ``RandomState`` draws, in
the same order). The TFRecord and unpaired sources, the prefetcher and the
device-resident sampler are not ported yet (the runner raises for real
data).
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


class SyntheticSource:
    """Uniform-random float32 image batches in [0, 1) under each of
    ``keys``, and one-hot ``conditional_labels`` of ``num_classes``."""

    def __init__(self, batch_size: int, hw: int, channels: int = 3, seed: int = 0,
                 keys: Sequence[str] = ("source", "target"), num_classes: int = 0):
        self.batch_size, self.hw, self.channels = batch_size, hw, channels
        self.keys = tuple(keys)
        self.num_classes = num_classes
        self._rng = np.random.RandomState(seed)

    def _item(self, key: str) -> np.ndarray:
        if key == "conditional_labels":
            ids = self._rng.randint(0, max(self.num_classes, 1), self.batch_size)
            hot = np.zeros((self.batch_size, max(self.num_classes, 1)), np.float32)
            hot[np.arange(self.batch_size), ids] = 1.0
            return hot
        return self._rng.rand(self.batch_size, self.hw, self.hw,
                              self.channels).astype(np.float32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield {k: self._item(k) for k in self.keys}
