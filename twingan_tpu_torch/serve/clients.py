"""Translation backends for serving, pure Python over the port's inferer.

Counterpart of ``MockTwinGANClient``, ``LocalTwinGANClient`` and
``BatchingLocalClient`` in ``twingan_tpu/serve/clients.py`` (the remote
TF-Serving and waifu2x HTTP clients are not ported). No PIL on this path.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class MockTwinGANClient:
    """Fixed-output client for driving a web stack without a model."""

    def __init__(self, image_hw: int = 64):
        self.image_hw = image_hw
        rng = np.random.RandomState(0)
        self._canned = rng.rand(image_hw, image_hw, 3).astype(np.float32)

    def do_inference(self, image: np.ndarray) -> np.ndarray:
        return self._canned.copy()


class LocalTwinGANClient:
    """Runs the translation in-process (on the card unless device='cpu')."""

    def __init__(self, model_path: str, image_hw: int = 0, direction: str = "s2t",
                 device=None):
        from twingan_tpu_torch.infer.translate import ImageInferer

        self.inferer = ImageInferer(model_path, image_hw, direction, device=device)
        self.image_hw = self.inferer.image_hw

    def do_inference(self, image: np.ndarray) -> np.ndarray:
        return self.inferer.infer_batch([image])[0]


class BatchingLocalClient:
    """Coalesces concurrent requests into one ``infer_batch`` call of up to
    ``max_batch`` images, waiting at most ``max_wait_ms`` for co-riders. A
    batch is padded to ``max_batch`` (repeating its last image) so the model
    always sees one shape. ``dispatches`` counts the ``infer_batch`` calls."""

    def __init__(self, inferer, max_batch: int = 16, max_wait_ms: float = 5.0):
        self.inferer = inferer
        self.image_hw = getattr(inferer, "image_hw", 0)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.dispatches = 0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                return
            batch = [first]
            shutdown = False
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    # Answer the requests already collected, then stop.
                    shutdown = True
                    break
                batch.append(item)
            images = [img for img, _ in batch]
            padded = images + [images[-1]] * (self.max_batch - len(images))
            try:
                self.dispatches += 1
                outs = self.inferer.infer_batch(padded)[: len(images)]
                for (_, fut), out in zip(batch, outs):
                    fut.set_result(out)
            except Exception as e:  # noqa: BLE001 - handed to every caller
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            if shutdown:
                return

    def do_inference(self, image: np.ndarray) -> np.ndarray:
        fut: Future = Future()
        self._q.put((image, fut))
        return fut.result(timeout=300)

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=5)
