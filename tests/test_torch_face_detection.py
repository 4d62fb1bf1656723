"""The port's Haar detector and face cropping against the JAX package's.

- the cascade parsed by both packages from the bundled XML gives equal
  arrays; the bundled file is OpenCV's frontal-face cascade, licence header
  included, and is the port's default;
- ``group_rectangles``, ``expand_box`` and ``square_crop`` agree on seeded
  random boxes and on edge cases;
- ``raw_boxes``, ``detect`` and ``crop_faces`` are equal (boxes as ints,
  crops as arrays) on the faces image (10 faces), on that image enlarged to
  240 x 800 (past 512 px: the pre-shrink path) and on seeded noise (no
  face: the whole image);
- ``PooledFaceDetector`` answers as the in-process detector does, also to
  concurrent threads, and its workers' module imports no torch;
- ``pil_bilinear_resize_f32`` equals PIL's mode "F" bilinear resize, bit
  for bit, on the detector's own cases (every pyramid level of the faces
  image, the pre-shrink of a 2048 x 768 image to 512 px) and at odd sizes.
"""

import hashlib
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from twingan_tpu.serve import face_detection as jface  # noqa: E402
from twingan_tpu.serve import haar as jhaar  # noqa: E402

from twingan_tpu_torch.data import preprocess, resample  # noqa: E402
from twingan_tpu_torch.serve import face_detection, haar  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = os.path.join(REPO, "tests", "data", "real_faces_gallery.png")
# OpenCV's haarcascade_frontalface_default.xml, unchanged.
CASCADE_SHA256 = "0f7d4527844eb514d4a4948e822da90fbb16a34a0bbbbc6adc6498747a5aafb0"


def faces_image() -> np.ndarray:
    return np.asarray(Image.open(FACES).convert("RGB"), np.uint8)


def images():
    img = faces_image()
    noise = (np.random.RandomState(0).rand(150, 210, 3) * 255).astype(np.uint8)
    return {"faces": img, "enlarged": resample.pil_bilinear_resize(img, 240, 800),
            "noise": noise}


@pytest.fixture(scope="module")
def detectors():
    return (jface.FaceDetector(haar.DEFAULT_CASCADE_PATH, max_faces=16),
            face_detection.FaceDetector(max_faces=16))


def test_bundled_cascade_is_the_default_and_parses_as_jax_does():
    path = haar.DEFAULT_CASCADE_PATH
    assert os.path.dirname(path) == os.path.join(REPO, "twingan_tpu_torch", "serve", "cascades")
    with open(path, "rb") as f:
        head = f.read(2000)
    assert b"Intel License Agreement" in head and b"Rainer Lienhart" in head
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == CASCADE_SHA256
    ours, theirs = haar.HaarCascade(path), jhaar.HaarCascade(path)
    assert (ours.height, ours.width) == (theirs.height, theirs.width) == (24, 24)
    np.testing.assert_array_equal(ours.rects, theirs.rects)
    assert ours.rects.dtype == theirs.rects.dtype
    assert len(ours.stages) == len(theirs.stages) == 25
    for a, b in zip(ours.stages, theirs.stages):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert haar.HaarFaceDetector().cascade.rects.shape == ours.rects.shape


def test_missing_cascade_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        haar.HaarFaceDetector(str(tmp_path / "nope.xml"))
    with pytest.raises(FileNotFoundError):
        face_detection.FaceDetector(str(tmp_path / "nope.xml"))
    assert face_detection.FaceDetector().available


def test_port_sources_name_no_system_cascade():
    for name in ("haar.py", "face_detection.py"):
        with open(os.path.join(REPO, "twingan_tpu_torch", "serve", name)) as f:
            text = f.read()
        assert "/usr/" not in text and "opencv4" not in text


@pytest.mark.parametrize("seed,min_neighbors", [(0, 3), (1, 1), (2, 5), (3, 3)])
def test_group_rectangles_matches(seed, min_neighbors):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 200, (5, 2))
    boxes = []
    for _ in range(40):  # jittered copies of a few boxes, and strays
        cx, cy = centres[rng.randint(5)]
        size = rng.uniform(24, 60)
        boxes.append([cx + rng.normal(0, 3), cy + rng.normal(0, 3), size, size])
    boxes = np.asarray(boxes + rng.uniform(0, 250, (8, 4)).tolist(), np.float64)
    ours = haar.group_rectangles(boxes, min_neighbors)
    theirs = jhaar.group_rectangles(boxes, min_neighbors)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype
    empty = np.zeros((0, 4))
    np.testing.assert_array_equal(haar.group_rectangles(empty), jhaar.group_rectangles(empty))


BOXES = [(200, 200, 100, 100, 1000, 1000), (10, 10, 100, 100, 120, 120),
         (0, 0, 30, 50, 40, 60), (95, 5, 10, 10, 100, 100), (3, 70, 33, 21, 64, 80),
         (0, 0, 1, 1, 1, 1)]


@pytest.mark.parametrize("box", BOXES)
def test_expand_and_square_crop_match(box):
    x, y, w, h, img_w, img_h = box
    expanded = face_detection.expand_box(x, y, w, h, img_w, img_h)
    assert expanded == jface.expand_box(x, y, w, h, img_w, img_h)
    assert (face_detection.square_crop(expanded, img_w, img_h)
            == jface.square_crop(expanded, img_w, img_h))
    for raw in ((0, 0, img_w, img_h), (x, y, x + w, y + 2 * h)):
        assert face_detection.square_crop(raw, img_w, img_h) == jface.square_crop(
            raw, img_w, img_h)


@pytest.mark.parametrize("name", ["faces", "enlarged", "noise"])
def test_detector_matches_jax(detectors, name):
    img = images()[name]
    theirs, ours = detectors
    raw = ours.raw_boxes(img)
    assert raw == theirs.raw_boxes(img)
    assert all(type(v) is int for box in raw for v in box)
    assert len(raw) == {"faces": 10, "enlarged": 10, "noise": 0}[name]
    assert ours.detect(img) == theirs.detect(img)
    crops, ref = ours.crop_faces(img), theirs.crop_faces(img)
    assert len(crops) == len(ref) == max(1, len(raw))
    for a, b in zip(crops, ref):
        np.testing.assert_array_equal(a, b)
    # max_faces caps the crops, largest first, as in the JAX detector.
    capped = face_detection.FaceDetector(max_faces=4)
    assert capped.detect(img) == ours.detect(img)[:4]


def test_pooled_detector_matches_in_process():
    img = faces_image()
    ref = face_detection.FaceDetector()
    pooled = face_detection.PooledFaceDetector(num_procs=2)
    try:
        assert pooled.raw_boxes(img) == ref.raw_boxes(img)
        for a, b in zip(pooled.crop_faces(img), ref.crop_faces(img)):
            np.testing.assert_array_equal(a, b)
        results = [None] * 4
        small = [img[:, :320], img[:, 320:], img, img[:100]]

        def worker(i):
            results[i] = pooled.raw_boxes(small[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == [ref.raw_boxes(s) for s in small]
    finally:
        pooled.close()


def test_pool_worker_module_imports_no_torch():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import twingan_tpu_torch.serve.face_detection\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'PIL', 'jax', 'twingan_tpu')))") % REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _pil_f(gray: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    return np.asarray(Image.fromarray(gray).resize((out_w, out_h), Image.BILINEAR), np.float32)


def _same_bits(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_resize_f32_matches_pil_on_the_pyramid():
    img = faces_image()
    gray = face_detection._rgb_to_gray(img.astype(np.float32))
    scale, levels = max(1.0, max(24, min(img.shape[:2]) // 10) / 24), 0
    while int(gray.shape[0] / scale) >= 24 and int(gray.shape[1] / scale) >= 24:
        sh, sw = int(gray.shape[0] / scale), int(gray.shape[1] / scale)
        _same_bits(preprocess.pil_bilinear_resize_f32(gray, sh, sw), _pil_f(gray, sh, sw))
        scale *= 1.2
        levels += 1
    assert levels == 12


@pytest.mark.parametrize("shape,out", [((768, 2048), (192, 512)), ((37, 53), (80, 11)),
                                       ((100, 100), (33, 77)), ((5, 7), (1, 1)),
                                       ((64, 64), (64, 32)), ((9, 300), (9, 300))])
def test_resize_f32_matches_pil(shape, out):
    rng = np.random.RandomState(sum(shape))
    gray = (rng.rand(*shape) * 255).astype(np.float32)
    _same_bits(resample.pil_bilinear_resize_f32(gray, *out), _pil_f(gray, *out))
    signed = (rng.randn(*shape) * 1e3).astype(np.float32)
    _same_bits(resample.pil_bilinear_resize_f32(signed, *out), _pil_f(signed, *out))
