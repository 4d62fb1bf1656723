"""The remote (TF-Serving REST) and waifu2x clients of both packages against
one stub HTTP server on 127.0.0.1 in this test (no network):

- ``RemoteTwinGANClient.do_inference``: both send the same instances (the
  image resized to image_hw by PIL's bilinear filter, in [0, 1]) and give
  equal arrays back;
- ``Waifu2xClient.post_request``: both post a PNG of the same pixels and
  decode the stub's 2x answer (PNG, or JPEG where PIL is present) to equal
  arrays; on a failing stub, a garbage answer or a dead port both give
  ``None``; the port's needs no PIL for PNG.
"""

import io
import json
import re
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from twingan_tpu.serve import clients as jclients  # noqa: E402

from twingan_tpu_torch.data import png  # noqa: E402
from twingan_tpu_torch.serve import clients  # noqa: E402


class Stub(BaseHTTPRequestHandler):
    """predict: returns 1 - x per instance; /api: the posted PNG (the first
    part), upscaled 2x by pixel repetition, as PNG (or JPEG, or garbage, or
    a 500, as ``mode`` says)."""

    mode = "png"
    seen: list = []

    def log_message(self, fmt, *args):
        pass

    def _send(self, code, data, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        Stub.seen.append((self.path, body))
        if self.path == "/v1/models/twingan:predict":
            instances = np.asarray(json.loads(body)["instances"], np.float32)
            self._send(200, json.dumps({"predictions": (1.0 - instances).tolist()}).encode(),
                       "application/json")
            return
        if Stub.mode == "fail":
            self._send(500, b"upscaler down", "text/plain")
            return
        if Stub.mode == "garbage":
            self._send(200, b"not an image", "image/png")
            return
        boundary = re.search(r"boundary=(\S+)", self.headers["Content-Type"]).group(1).encode()
        part = body.split(b"--" + boundary)[1]
        payload = part.split(b"\r\n\r\n", 1)[1].rstrip(b"\r\n")
        big = png.decode_png(payload).repeat(2, axis=0).repeat(2, axis=1)
        if Stub.mode == "png":
            self._send(200, png.encode_png(big), "image/png")
            return
        buf = io.BytesIO()
        Image.fromarray(big).save(buf, format="JPEG")
        self._send(200, buf.getvalue(), "image/jpeg")


@pytest.fixture(scope="module")
def stub():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


@pytest.mark.parametrize("shape,hw", [((50, 70, 3), 32), ((64, 64, 3), 64), ((17, 9, 3), 40)])
def test_remote_client_matches(stub, shape, hw):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    Stub.seen.clear()
    ours = clients.RemoteTwinGANClient(stub, image_hw=hw).do_inference(img)
    theirs = jclients.RemoteTwinGANClient(stub, image_hw=hw).do_inference(img)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (hw, hw, 3)
    np.testing.assert_array_equal(ours, theirs)
    (p1, b1), (p2, b2) = Stub.seen
    assert p1 == p2 == "/v1/models/twingan:predict" and b1 == b2  # the same request
    assert clients.RemoteTwinGANClient(stub + "/").url == jclients.RemoteTwinGANClient(
        stub + "/").url


@pytest.mark.parametrize("mode", ["png", "jpeg"])
def test_waifu2x_matches(stub, mode):
    Stub.mode = mode
    img = np.random.RandomState(3).rand(24, 20, 3).astype(np.float32) * 1.2 - 0.1
    ours = clients.Waifu2xClient(stub).post_request(img)
    theirs = jclients.Waifu2xClient(stub).post_request(img)
    assert ours is not None and ours.shape == (48, 40, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    if mode == "png":
        expect = np.clip(img * 255, 0, 255).astype(np.uint8).repeat(2, 0).repeat(2, 1)
        np.testing.assert_array_equal(ours, expect.astype(np.float32) / 255.0)


@pytest.mark.parametrize("mode", ["fail", "garbage", "dead"])
def test_waifu2x_failures_give_none(stub, mode):
    Stub.mode = mode
    url = "http://127.0.0.1:9" if mode == "dead" else stub
    img = np.zeros((8, 8, 3), np.float32)
    assert clients.Waifu2xClient(url, timeout=5).post_request(img) is None
    assert jclients.Waifu2xClient(url, timeout=5).post_request(img) is None


def test_waifu2x_png_needs_no_pil(stub, monkeypatch):
    Stub.mode = "png"
    img = np.random.RandomState(4).rand(10, 12, 3).astype(np.float32)
    expect = clients.Waifu2xClient(stub).post_request(img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(clients.Waifu2xClient(stub).post_request(img), expect)
