"""The port's HTTP server against the JAX package's, both on ephemeral
ports of 127.0.0.1 and serving the same ``MockTwinGANClient`` output:

- the faces image uploaded raw, as multipart form data and as base64 JSON
  gives the same ``num_faces`` from both servers and in every form, and
  output PNGs equal pixel for pixel once decoded (the bytes may differ:
  the port writes PNG with its own encoder);
- the ``detect_face`` preview gives the same marked image and flag;
- bad requests get the same status codes; ``/healthz`` and both static
  pages answer the same;
- a GET polls for an output written after it arrived; ``--sync_writes``
  writes before answering;
- ``--quantize`` reaches the local client (``test_torch_quantize_serve.py``
  serves a stage with it) and a mock server takes it, and without
  PIL a JPEG upload or a labelled preview answers 500 naming PIL (never
  400 "no image found"), while PNG uploads still serve.
"""

import base64
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from twingan_tpu.serve import clients as jclients  # noqa: E402
from twingan_tpu.serve import face_detection as jface  # noqa: E402
from twingan_tpu.serve import server as jserver  # noqa: E402

from twingan_tpu_torch.serve import clients, face_detection, haar, server  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = os.path.join(REPO, "tests", "data", "real_faces_gallery.png")


def faces_png() -> bytes:
    with open(FACES, "rb") as f:
        return f.read()


def start(service, handler_factory):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_factory(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX url, port url, port service)."""
    root = tmp_path_factory.mktemp("serve")
    jservice = jserver.TranslationService(
        jclients.MockTwinGANClient(image_hw=32),
        jface.FaceDetector(haar.DEFAULT_CASCADE_PATH), str(root / "jax"))
    service = server.TranslationService(clients.MockTwinGANClient(image_hw=32),
                                        face_detection.FaceDetector(), str(root / "port"))
    jhttpd, jurl = start(jservice, jserver.make_handler)
    httpd, url = start(service, server.make_handler)
    yield jurl, url, service
    jhttpd.shutdown()
    httpd.shutdown()


def request(url, data=None, ctype=None):
    """(status, body bytes) of a GET (data None) or POST."""
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def multipart(payload: bytes, filename="x.png", ctype="image/png", boundary="----testboundary"):
    body = (f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="note"\r\n\r\nhello\r\n'
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
            f"Content-Type: {ctype}\r\n\r\n").encode() + payload + (
                f"\r\n--{boundary}--\r\n".encode())
    return body, f"multipart/form-data; boundary={boundary}"


def forms(png: bytes):
    return {"raw": (png, "image/png"), "multipart": multipart(png),
            "base64": (json.dumps({"image": base64.b64encode(png).decode()}).encode(),
                       "application/json")}


def decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def served_images(url, answer):
    out = []
    for o in answer["outputs"]:
        for key in ("combined", "translated"):
            code, data = request(url + o[key])
            assert code == 200
            out.append(decode(data))
    return out


def test_upload_forms_match_jax(servers):
    jurl, url, _ = servers
    first = None
    for name, (body, ctype) in forms(faces_png()).items():
        answers = []
        for base in (jurl, url):
            code, data = request(base, body, ctype)
            assert code == 200, data
            answers.append(json.loads(data))
        theirs, ours = answers
        assert ours["status"] == theirs["status"] == "success"
        assert set(ours) == set(theirs)
        assert ours["num_faces"] == theirs["num_faces"] == 4  # 10 faces, max_faces 4
        images = served_images(url, ours)
        for a, b in zip(images, served_images(jurl, theirs)):
            np.testing.assert_array_equal(a, b)
        assert images[0].shape == (32, 64, 3)  # the combine: face beside its translation
        if first is None:
            first = images
        for a, b in zip(images, first):
            np.testing.assert_array_equal(a, b)


def test_jpeg_and_noise_uploads_match_jax(servers):
    jurl, url, _ = servers
    buf = io.BytesIO()
    noise = (np.random.RandomState(0).rand(70, 90, 3) * 255).astype(np.uint8)
    Image.fromarray(noise).save(buf, format="JPEG", quality=90)
    for body, ctype in (multipart(buf.getvalue(), "x.jpg", "image/jpeg"),
                        (buf.getvalue(), "image/jpeg")):
        (jc, jdata), (c, data) = request(jurl, body, ctype), request(url, body, ctype)
        assert c == jc == 200
        theirs, ours = json.loads(jdata), json.loads(data)
        assert ours["num_faces"] == theirs["num_faces"] == 1  # the whole image
        for a, b in zip(served_images(url, ours), served_images(jurl, theirs)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["faces", "noise"])
def test_detect_face_matches_jax(servers, name):
    jurl, url, _ = servers
    if name == "faces":
        png = faces_png()
    else:
        buf = io.BytesIO()
        Image.fromarray(np.zeros((64, 48, 3), np.uint8)).save(buf, format="PNG")
        png = buf.getvalue()
    body = json.dumps({"image": base64.b64encode(png).decode(), "detect_face": True}).encode()
    answers = []
    for base in (jurl, url):
        code, data = request(base, body, "application/json")
        assert code == 200, data
        answers.append(json.loads(data))
    theirs, ours = answers
    assert set(ours) == set(theirs) == {"status", "image", "face_found"}
    assert ours["face_found"] is theirs["face_found"] is (name == "faces")
    assert ours["image"].startswith("data:image/PNG;base64,")
    np.testing.assert_array_equal(decode(base64.b64decode(ours["image"].split(",", 1)[1])),
                                  decode(base64.b64decode(theirs["image"].split(",", 1)[1])))


def test_bad_requests_get_the_same_codes(servers):
    jurl, url, _ = servers
    cases = [
        ("/", b"not an image", "image/png"),
        ("/", b"", "image/png"),  # content length 0
        ("/", b"hello", "text/plain"),
        ("/", multipart(b"plain text, no image", "t.txt", "text/plain")[0],
         multipart(b"")[1]),
        ("/", b"--x\r\n\r\nno boundary given", "multipart/form-data"),
        ("/", json.dumps({"no_image": 1}).encode(), "application/json"),
        ("/", b"{broken json", "application/json"),
        ("/", json.dumps({"image": "bm90IGFuIGltYWdl"}).encode(), "application/json"),
        ("/nope", None, None),
        ("/outputs/../../README.md", None, None),  # only the basename is served
    ]
    codes = []
    for path, body, ctype in cases:
        (jc, _), (c, data) = request(jurl + path, body, ctype), request(url + path, body, ctype)
        assert c == jc, (path, body, ctype, c, jc, data)
        codes.append(c)
    assert codes == [500, 400, 400, 400, 400, 500, 500, 500, 404, 404]
    assert request(url + "/healthz") == request(jurl + "/healthz") == (200, b'{"status": "ok"}')


@pytest.mark.parametrize("page", ["/", "/index.html", "/index_webcam.html"])
def test_static_pages_match(servers, page):
    jurl, url, _ = servers
    code, body = request(url + page)
    assert (code, body) == request(jurl + page)
    assert b"TwinGAN" in body


def test_get_polls_for_a_late_file(servers):
    _, url, service = servers
    name = "late_0_translated.png"
    payload = service.writer is not None and b"\x89PNG late"
    assert payload
    threading.Timer(0.3, lambda: open(os.path.join(service.output_dir, name), "wb").write(
        payload)).start()
    t0 = time.time()
    assert request(f"{url}/outputs/{name}") == (200, payload)
    assert 0.25 < time.time() - t0 < 3.0


def test_sync_writes_and_deferred_writes(tmp_path):
    img = np.asarray(Image.open(FACES).convert("RGB"), np.uint8)
    sync = server.build_service(server.parse_args(
        ["--debug", "--sync_writes", "--image_hw=32", f"--output_dir={tmp_path / 'sync'}"]))
    assert sync.writer is None
    answer = sync.handle_image(img)
    files = [os.path.join(sync.output_dir, os.path.basename(o[k]))
             for o in answer["outputs"] for k in ("combined", "translated")]
    assert len(files) == 8 and all(os.path.exists(f) for f in files)
    deferred = server.build_service(server.parse_args(
        ["--debug", "--image_hw=32", f"--output_dir={tmp_path / 'deferred'}"]))
    later = deferred.handle_image(img)
    deferred.writer.join()
    assert not [f for f in os.listdir(deferred.output_dir) if ".tmp" in f]
    jservice = jserver.TranslationService(
        jclients.MockTwinGANClient(image_hw=32), jface.FaceDetector(haar.DEFAULT_CASCADE_PATH),
        str(tmp_path / "jax"), defer_writes=False)
    ref = jservice.handle_image(img)
    for ours_answer, out_dir in ((answer, sync.output_dir), (later, deferred.output_dir)):
        for o, j in zip(ours_answer["outputs"], ref["outputs"]):
            for k in ("combined", "translated"):
                with open(os.path.join(out_dir, os.path.basename(o[k])), "rb") as f:
                    ours = decode(f.read())
                with open(os.path.join(jservice.output_dir, os.path.basename(j[k])), "rb") as f:
                    np.testing.assert_array_equal(ours, decode(f.read()))


def test_flags_that_raise_and_the_defaults():
    mock = server.build_service(server.parse_args(["--debug", "--quantize"]))
    assert isinstance(mock.client, clients.MockTwinGANClient)  # no model to quantize
    with pytest.raises(SystemExit):
        server.parse_args([])  # no model, no --debug, no --serving_url
    args = server.parse_args(["--model_path=/nowhere"])
    assert args.device is None and args.serve_batch == 8 and args.detector_procs == 0
    remote = server.build_service(server.parse_args(["--serving_url=http://127.0.0.1:1",
                                                     "--max_faces=2"]))
    assert isinstance(remote.client, clients.RemoteTwinGANClient)
    assert remote.client.image_hw == 256 and remote.max_faces == 2


def test_without_pil_uploads_that_need_it_say_so(servers, monkeypatch):
    _, url, _ = servers
    buf = io.BytesIO()
    Image.fromarray((np.random.RandomState(1).rand(40, 40, 3) * 255).astype(np.uint8)).save(
        buf, format="JPEG")
    jpeg = buf.getvalue()
    png = faces_png()
    monkeypatch.setitem(sys.modules, "PIL", None)
    for body, ctype in ((jpeg, "image/jpeg"), multipart(jpeg, "x.jpg", "image/jpeg")):
        code, data = request(url, body, ctype)
        assert code == 500 and "needs PIL" in json.loads(data)["message"], data
    for body, ctype in forms(png).values():
        code, data = request(url, body, ctype)
        assert code == 200 and json.loads(data)["num_faces"] == 4
        served_images_without_pil = [request(url + o["translated"])[0]
                                     for o in json.loads(data)["outputs"]]
        assert served_images_without_pil == [200] * 4
    body = json.dumps({"image": base64.b64encode(png).decode(), "detect_face": True}).encode()
    code, data = request(url, body, "application/json")
    assert code == 500 and "needs PIL" in json.loads(data)["message"]
