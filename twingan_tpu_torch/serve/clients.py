"""Translation backends for serving, pure Python over the port's inferer.

Counterpart of ``twingan_tpu/serve/clients.py``:
- ``MockTwinGANClient``: a canned image, for driving the web stack
  without a model (the server's ``--debug``);
- ``LocalTwinGANClient``: the in-process ``ImageInferer``, on the card
  unless ``device="cpu"``;
- ``BatchingLocalClient``: coalesces concurrent requests into one batch;
- ``RemoteTwinGANClient``: a TF-Serving REST predict call with a 5 s
  deadline;
- ``Waifu2xClient``: the optional HTTP 2x upscale hop, best-effort
  (``None`` on any failure).
No PIL on these paths: the remote client resizes with
``data/resample.py:pil_bilinear_resize`` (PIL's bilinear filter, to the
bit), and waifu2x's PNG is encoded and decoded by ``data/png.py`` (a reply
in another format goes to PIL, and without PIL is a failure like any
other).
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request
from concurrent.futures import Future
from typing import Optional

import numpy as np

from twingan_tpu_torch.data.png import encode_png
from twingan_tpu_torch.data.resample import pil_bilinear_resize
from twingan_tpu_torch.utils.image_io import decode_image


class MockTwinGANClient:
    """Fixed-output client for driving a web stack without a model."""

    def __init__(self, image_hw: int = 64):
        self.image_hw = image_hw
        rng = np.random.RandomState(0)
        self._canned = rng.rand(image_hw, image_hw, 3).astype(np.float32)

    def do_inference(self, image: np.ndarray) -> np.ndarray:
        return self._canned.copy()


class LocalTwinGANClient:
    """Runs the translation in-process (on the card unless device='cpu');
    ``quantize`` serves the int8 path (``ImageInferer``)."""

    def __init__(self, model_path: str, image_hw: int = 0, direction: str = "s2t",
                 device=None, quantize: bool = False):
        from twingan_tpu_torch.infer.translate import ImageInferer

        self.inferer = ImageInferer(model_path, image_hw, direction, device=device,
                                    quantize=quantize)
        self.image_hw = self.inferer.image_hw

    def do_inference(self, image: np.ndarray) -> np.ndarray:
        return self.inferer.infer_batch([image])[0]


class RemoteTwinGANClient:
    """TF-Serving REST client: the reference's predict request with a 5 s
    deadline, one image an instance in [0, 1] at ``image_hw``."""

    def __init__(self, server_url: str, model_name: str = "twingan", image_hw: int = 256,
                 timeout: float = 5.0):
        self.url = f"{server_url.rstrip('/')}/v1/models/{model_name}:predict"
        self.image_hw = image_hw
        self.timeout = timeout

    def do_inference(self, image: np.ndarray) -> np.ndarray:
        img = pil_bilinear_resize(image, self.image_hw, self.image_hw)
        arr = (np.asarray(img, np.float32) / 255.0)[None].tolist()
        payload = json.dumps({"instances": arr}).encode()
        req = urllib.request.Request(self.url, data=payload,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        return np.asarray(out["predictions"][0], np.float32)


class Waifu2xClient:
    """HTTP client for an external waifu2x upscaling server."""

    def __init__(self, server_url: str, timeout: float = 10.0):
        self.server_url = server_url
        self.timeout = timeout

    def post_request(self, image: np.ndarray, scale: int = 2) -> Optional[np.ndarray]:
        png = encode_png(np.clip(image * 255, 0, 255).astype(np.uint8))
        boundary = "----twinganboundary"
        body = (f"--{boundary}\r\n"
                f'Content-Disposition: form-data; name="file"; filename="in.png"\r\n'
                f"Content-Type: image/png\r\n\r\n").encode() + png + (
                    f"\r\n--{boundary}--\r\n".encode())
        req = urllib.request.Request(
            f"{self.server_url.rstrip('/')}/api?scale={scale}", data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return decode_image(resp.read()).astype(np.float32) / 255.0
        except Exception:  # noqa: BLE001 - upscaling is best-effort, like the reference
            return None


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
