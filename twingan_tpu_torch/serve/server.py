"""HTTP serving front door: upload a photo, get translated face(s) back.

Counterpart of ``twingan_tpu/serve/server.py``, with its routes, request
forms and answers: POST an image (raw ``image/*``, multipart form data, or
base64 JSON, whose ``detect_face`` asks for the detection preview instead)
-> face detect and crop -> per-face translate -> optional waifu2x 2x
upscale -> side-by-side combine -> JSON with the output paths; GET serves
the static pages (``static/``), the output PNGs (polling up to 3 s for
one still being written) and ``/healthz``.

What differs from the JAX server is what it needs installed. PNG uploads
decode and every output PNG is written without PIL (``data/png.py``), and
the combine resizes with ``data/resample.py:pil_bilinear_resize`` (PIL's
bilinear filter, to the bit). An upload in another format goes to PIL,
imported when it is needed: where PIL is missing, the answer is a 500
whose message names PIL (never the 400 "no image found" of an upload that
is not an image), and so is a ``detect_face`` preview, whose label text
needs PIL's font. The model runs on the card unless ``--device=cpu``.
``--quantize`` serves the W8A8 int8 path (kernel Q1), its scales
calibrated on the first ``CALIB_MIN_IMAGES`` images served (the first
batch included, which is served in int8 already) and then frozen.

Run:
    python -m twingan_tpu_torch.serve.server --model_path=/trained --port=8222
    python -m twingan_tpu_torch.serve.server --debug --port=8222   # mock model
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import re
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from twingan_tpu_torch.data.resample import pil_bilinear_resize
from twingan_tpu_torch.serve.clients import (
    BatchingLocalClient,
    LocalTwinGANClient,
    MockTwinGANClient,
    RemoteTwinGANClient,
    Waifu2xClient,
)
from twingan_tpu_torch.serve.face_detection import FaceDetector, PooledFaceDetector
from twingan_tpu_torch.utils.image_io import (
    base64_to_numpy,
    decode_image,
    imsave_float,
    numpy_to_base64,
)

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")
MAX_UPLOAD_BYTES = 16 << 20


class _AsyncImageWriter:
    """One background thread that takes PNG encode and write work off the
    request's path: the client gets its JSON before the encode. Files land
    atomically (tmp + rename), so the GET side's polling never serves a
    half-written PNG."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, arr = item
                tmp = f"{path}.{threading.get_ident()}.tmp.png"
                imsave_float(tmp, arr, fast=True)
                os.replace(tmp, path)
            except Exception as e:  # noqa: BLE001 - never kill the writer
                print(f"async image write failed for {item and item[0]}: {e}")
            finally:
                self._q.task_done()

    def submit(self, path: str, arr: np.ndarray) -> None:
        self._q.put((path, arr))

    def join(self) -> None:
        """Block until every submitted image is on disk (tests, shutdown)."""
        self._q.join()


class TranslationService:
    """The request pipeline, shared by all handler threads."""

    def __init__(self, client, detector: FaceDetector, output_dir: str,
                 waifu2x: Optional[Waifu2xClient] = None, max_faces: int = 4,
                 defer_writes: bool = True):
        self.client = client
        self.detector = detector
        self.output_dir = output_dir
        self.waifu2x = waifu2x
        self.max_faces = max_faces
        self._lock = threading.Lock()
        self.writer = _AsyncImageWriter() if defer_writes else None
        os.makedirs(output_dir, exist_ok=True)

    def _save(self, path: str, arr: np.ndarray) -> None:
        if self.writer is not None:
            self.writer.submit(path, arr)
        else:
            imsave_float(path, arr, fast=True)

    def handle_image(self, image: np.ndarray) -> dict:
        t0 = time.time()
        request_id = uuid.uuid4().hex[:16]
        faces = self.detector.crop_faces(image)[: self.max_faces]
        outputs = []
        for i, face in enumerate(faces):
            if isinstance(self.client, BatchingLocalClient):
                translated = self.client.do_inference(face)  # queue batches
            else:
                with self._lock:  # one model call at a time
                    translated = self.client.do_inference(face)
            if self.waifu2x is not None:
                upscaled = self.waifu2x.post_request(translated)
                if upscaled is not None:
                    translated = upscaled
            # Side-by-side combine: the face resized to the output's size.
            hw = translated.shape[0]
            face_resized = pil_bilinear_resize(face, hw, hw).astype(np.float32) / 255.0
            combined = np.concatenate([face_resized, translated], axis=1)
            name = f"{request_id}_{i}.png"
            self._save(os.path.join(self.output_dir, name), combined)
            translated_name = f"{request_id}_{i}_translated.png"
            self._save(os.path.join(self.output_dir, translated_name), translated)
            outputs.append({"combined": f"/outputs/{name}",
                            "translated": f"/outputs/{translated_name}"})
        return {
            "status": "success",
            "request_id": request_id,
            "num_faces": len(faces),
            "outputs": outputs,
            "latency_sec": round(time.time() - t0, 3),
        }


def _parse_multipart_image(body: bytes, content_type: str) -> Optional[np.ndarray]:
    """The first part that decodes as an image, or None. A part that PIL
    would have to decode where PIL is missing does not count as "not an
    image": if no other part decodes, its ``ImportError`` is raised."""
    m = re.search(r'boundary="?([^";,]+)"?', content_type)
    if not m:
        return None
    boundary = ("--" + m.group(1)).encode()
    missing: Optional[ImportError] = None
    for part in body.split(boundary):
        if b"\r\n\r\n" not in part:
            continue
        headers, payload = part.split(b"\r\n\r\n", 1)
        if b"filename=" not in headers and b"image" not in headers.lower():
            continue
        payload = payload.rstrip(b"\r\n-")
        try:
            return decode_image(payload)
        except ImportError as e:
            missing = missing or e
        except Exception:  # noqa: BLE001 - not an image: try the next part
            continue
    if missing is not None:
        raise missing
    return None


def make_handler(service: TranslationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/", "/index.html"):
                self._file(os.path.join(STATIC_DIR, "index.html"), "text/html")
            elif path == "/index_webcam.html":
                self._file(os.path.join(STATIC_DIR, "index_webcam.html"), "text/html")
            elif path.startswith("/outputs/"):
                # Output PNGs are written after the POST's answer: poll
                # briefly for a file that is still being written.
                name = os.path.basename(path)
                full = os.path.join(service.output_dir, name)
                deadline = time.time() + 3.0
                while (service.writer is not None and not os.path.exists(full)
                       and time.time() < deadline):
                    time.sleep(0.02)
                self._file(full, "image/png")
            elif path == "/healthz":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"status": "not_found"})

        def _file(self, path: str, ctype: str):
            if not os.path.exists(path):
                self._json(404, {"status": "not_found"})
                return
            with open(path, "rb") as f:
                data = f.read()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > MAX_UPLOAD_BYTES:
                    self._json(400, {"status": "error", "message": "bad content length"})
                    return
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                image = None
                if ctype.startswith("multipart/form-data"):
                    image = _parse_multipart_image(body, ctype)
                elif ctype.startswith("image/"):
                    image = decode_image(body)
                elif ctype.startswith("application/json"):
                    payload = json.loads(body)
                    image = base64_to_numpy(payload["image"])
                    if payload.get("detect_face"):
                        # Face-detection preview: the marked image, no
                        # translation.
                        marked, found = service.detector.mark_face(image)
                        self._json(200, {
                            "status": "success",
                            "image": numpy_to_base64(marked),
                            "face_found": found,
                        })
                        return
                if image is None:
                    self._json(400, {"status": "error", "message": "no image found in request"})
                    return
                self._json(200, service.handle_image(image))
            except Exception as e:  # noqa: BLE001 - always answer the client
                self._json(500, {"status": "error", "message": str(e)})

    return Handler


def build_service(args) -> TranslationService:
    if args.debug:
        client = MockTwinGANClient(image_hw=args.image_hw or 64)
    elif args.serving_url:
        client = RemoteTwinGANClient(args.serving_url, image_hw=args.image_hw or 256)
    else:
        local = LocalTwinGANClient(args.model_path, args.image_hw, args.direction,
                                   device=getattr(args, "device", None),
                                   quantize=getattr(args, "quantize", False))
        client = BatchingLocalClient(local.inferer, max_batch=args.serve_batch) \
            if args.serve_batch > 1 else local
    waifu2x = Waifu2xClient(args.waifu2x_url) if args.waifu2x_url else None
    procs = getattr(args, "detector_procs", 0)
    if procs > 0:
        detector = PooledFaceDetector(num_procs=procs, max_faces=args.max_faces)
    else:
        detector = FaceDetector(max_faces=args.max_faces)
    return TranslationService(client, detector, args.output_dir, waifu2x, args.max_faces,
                              defer_writes=not getattr(args, "sync_writes", False))


def parse_args(argv=None):
    # Imported here: it loads torch, which the detector's worker processes
    # (spawned, re-importing this module) do not need.
    from twingan_tpu_torch.infer.quantize import CALIB_MIN_IMAGES

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", default="")
    p.add_argument("--serving_url", default="", help="TF-Serving REST endpoint (remote mode)")
    p.add_argument("--image_hw", type=int, default=0)
    p.add_argument("--direction", default="s2t", choices=["s2t", "t2s"])
    p.add_argument("--port", type=int, default=8222)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--output_dir",
                   default=os.path.join(tempfile.gettempdir(), "twingan_serve_outputs"))
    p.add_argument("--waifu2x_url", default="")
    p.add_argument("--max_faces", type=int, default=4)
    p.add_argument("--serve_batch", type=int, default=8,
                   help="coalesce concurrent requests into one batch (1 disables)")
    p.add_argument("--detector_procs", type=int, default=0,
                   help="run Haar detection in N worker processes so concurrent requests "
                        "detect on separate cores (0 = in the request thread)")
    p.add_argument("--sync_writes", action="store_true",
                   help="write output PNGs on the request thread before answering (default: "
                        "deferred to a writer thread; the GET side polls for late files)")
    p.add_argument("--quantize", action="store_true",
                   help="serve the W8A8 int8 path (kernel Q1); the scales calibrate on the "
                        f"first {CALIB_MIN_IMAGES} images served, the first request's batch "
                        "included (that batch is already served in int8), then freeze")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--debug", action="store_true", help="mock model (no checkpoint needed)")
    args = p.parse_args(argv)
    if not args.debug and not args.serving_url and not args.model_path:
        p.error("--model_path required (or --debug / --serving_url)")
    return args


def main(argv=None):
    args = parse_args(argv)
    service = build_service(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"serving on http://{args.host}:{args.port} "
          f"(mode={'mock' if args.debug else 'remote' if args.serving_url else 'local'})")
    server.serve_forever()


if __name__ == "__main__":
    main()
