"""The serving slice end to end on the CPU: a 32 px TwinGAN bridged from a
JAX ``TwinGANTrainer`` state (``tests/test_torch_translate.py``'s stage:
batch norm, UNet, self-attention at 16 px, norms randomized from a seed)
served by the port's HTTP server through ``LocalTwinGANClient`` and
``BatchingLocalClient`` on the CPU. Each translated face, decoded from the
PNG the server wrote, is within 1/255 (the 8-bit quantization of the
write) plus that file's ``TOL`` of JAX ``TwinGANTrainer.translate`` on the
same crop; the combine's left half is the crop resized as PIL resizes it.

Also here: ``ImageInferer.infer`` against ``infer_batch``; the two small
repairs of this slice, each with the case that failed before it
(``imread_rgb`` decodes PNG without PIL; ``_iter_images`` lists a folder
in the JAX order, sorted paths, where files sit beside subfolders); and
the server's local model needing the card unless ``--device=cpu``.
"""

import io
import json
import os
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_twingan_step import _unoptimized_jax_reference  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from test_torch_translate import TOL, _stage  # noqa: E402
from twingan_tpu.data import preprocess as jpreprocess  # noqa: E402
from twingan_tpu.infer import translate as jtranslate  # noqa: E402
from twingan_tpu.serve.face_detection import FaceDetector as JaxFaceDetector  # noqa: E402

from twingan_tpu_torch.data.resample import pil_bilinear_resize  # noqa: E402
from twingan_tpu_torch.infer import translate as ptranslate  # noqa: E402
from twingan_tpu_torch.infer.translate import ImageInferer  # noqa: E402
from twingan_tpu_torch.serve import clients, face_detection, haar, server  # noqa: E402
from twingan_tpu_torch.utils import image_io  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = os.path.join(REPO, "tests", "data", "real_faces_gallery.png")


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """(JAX trainer, its state, the port's stage dir), threads capped."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    trainer, state, stage_dir = _stage(tmp_path_factory.mktemp("e2e"))
    yield trainer, state, stage_dir
    torch.set_num_threads(threads)


def fetch(url: str) -> np.ndarray:
    with urllib.request.urlopen(url, timeout=60) as r:
        return np.asarray(Image.open(io.BytesIO(r.read())).convert("RGB"), np.uint8)


@pytest.mark.parametrize("batching", [False, True])
def test_served_faces_match_jax_translate(tmp_path, bridged, batching):
    trainer, state, stage_dir = bridged
    local = clients.LocalTwinGANClient(stage_dir, device="cpu")
    client = (clients.BatchingLocalClient(local.inferer, max_batch=4, max_wait_ms=100.0)
              if batching else local)
    service = server.TranslationService(client, face_detection.FaceDetector(),
                                        str(tmp_path / "out"))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with open(FACES, "rb") as f:
            body = f.read()
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answer = json.loads(r.read())
        img = np.asarray(Image.open(FACES).convert("RGB"), np.uint8)
        crops = JaxFaceDetector(haar.DEFAULT_CASCADE_PATH).crop_faces(img)
        assert answer["num_faces"] == len(crops) == 4
        batch = np.stack([jpreprocess.host_resize(c, "RESHAPE", 32) for c in crops])
        ref = np.clip(np.asarray(trainer.translate(state, jnp.asarray(batch), "s2t")), 0, 1)
        for out, crop, expect in zip(answer["outputs"], crops, ref):
            translated = fetch(url + out["translated"]).astype(np.float32) / 255.0
            np.testing.assert_allclose(translated, expect, rtol=TOL["rtol"],
                                       atol=TOL["atol"] + 1 / 255)
            combined = fetch(url + out["combined"])
            assert combined.shape == (32, 64, 3)
            np.testing.assert_array_equal(combined[:, :32], pil_bilinear_resize(crop, 32, 32))
            np.testing.assert_array_equal(combined[:, 32:], fetch(url + out["translated"]))
        if batching:
            assert 1 <= client.dispatches <= 4
    finally:
        httpd.shutdown()
        if batching:
            client.close()


def test_infer_agrees_with_infer_batch(tmp_path, bridged):
    _, _, stage_dir = bridged
    inferer = ImageInferer(stage_dir, device="cpu")
    img = np.random.RandomState(7).randint(0, 256, (40, 36, 3)).astype(np.uint8)
    src = str(tmp_path / "in.png")
    image_io.imsave_float(src, img.astype(np.float32) / 255.0)
    expect = inferer.infer_batch([img])[0]
    dst = str(tmp_path / "out" / "x.png")
    assert inferer.infer(src, dst) is None
    np.testing.assert_array_equal(
        image_io.imread_rgb(dst), np.clip(expect * 255.0, 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(inferer.infer(src, dst, return_image=True), expect)


def test_imread_rgb_decodes_png_without_pil(tmp_path, monkeypatch):
    img = np.random.RandomState(8).randint(0, 256, (9, 13, 4)).astype(np.uint8)
    path = str(tmp_path / "rgba.img")  # the signature names the format, not the suffix
    Image.fromarray(img).save(path, format="PNG")
    expect = np.asarray(Image.open(path).convert("RGB"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(image_io.imread_rgb(path), expect)
    jpeg = str(tmp_path / "x.jpg")
    with open(jpeg, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(32))
    with pytest.raises(ImportError, match="non-PNG image needs PIL"):
        image_io.imread_rgb(jpeg)


def test_iter_images_lists_a_folder_as_jax_does(tmp_path):
    (tmp_path / "a").mkdir()
    for rel in ("b.png", "a/x.png", "a/B.JPG", "c.txt", "0.webp"):
        (tmp_path / rel).write_bytes(b"")
    ours = list(ptranslate._iter_images(str(tmp_path)))
    assert ours == list(jtranslate._iter_images(str(tmp_path)))
    assert [os.path.relpath(p, tmp_path) for p in ours] == ["0.webp", "a/B.JPG", "a/x.png",
                                                           "b.png"]
    assert list(ptranslate._iter_images(str(tmp_path / "b.png"))) == [str(tmp_path / "b.png")]


def test_server_model_needs_the_card_unless_cpu(bridged, monkeypatch):
    _, _, stage_dir = bridged
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.build_service(server.parse_args([f"--model_path={stage_dir}"]))
    service = server.build_service(server.parse_args(
        [f"--model_path={stage_dir}", "--device=cpu", "--serve_batch=2", "--detector_procs=0"]))
    try:
        assert service.client.inferer.device == torch.device("cpu")
        img = np.asarray(Image.open(FACES).convert("RGB"), np.uint8)
        with ThreadPoolExecutor(2) as pool:
            outs = list(pool.map(service.client.do_inference, [img[:, :200], img[:, 300:]]))
        assert all(o.shape == (32, 32, 3) for o in outs)
    finally:
        service.client.close()
