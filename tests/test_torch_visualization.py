"""The port's drawing and label-map utilities and the base64 image helpers
against the JAX package's, with PIL present:

- every drawing function (boxes with and without labels, in normalized and
  absolute coordinates, at the image's edges; keypoints; masks;
  ``visualize_boxes_and_labels_on_image_array`` with scores, without, and
  over ``max_boxes_to_draw``) gives an image equal to the JAX one, byte for
  byte, and raises where it raises;
- ``FaceDetector.mark_face`` gives the JAX preview on the faces image and
  on a face-free one;
- label maps parse to the same dicts;
- ``numpy_to_base64``/``base64_to_numpy`` round-trip without PIL, decode
  the JAX package's data URIs, and return a writable array;
- without PIL, label text raises ``ImportError`` naming PIL while boxes,
  keypoints and masks still draw.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from twingan_tpu.serve import face_detection as jface  # noqa: E402
from twingan_tpu.utils import image_io as jimage_io  # noqa: E402
from twingan_tpu.utils import visualization as jviz  # noqa: E402

from twingan_tpu_torch.serve import face_detection, haar  # noqa: E402
from twingan_tpu_torch.utils import image_io  # noqa: E402
from twingan_tpu_torch.utils import visualization as viz  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = os.path.join(REPO, "tests", "data", "real_faces_gallery.png")


def _img(h=48, w=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def both(fn_name, *args, **kw):
    """Calls the drawing function of both packages on copies of the same
    image (the first argument); returns both images."""
    img, rest = args[0], args[1:]
    ours, theirs = img.copy(), img.copy()
    r1 = getattr(viz, fn_name)(ours, *rest, **kw)
    r2 = getattr(jviz, fn_name)(theirs, *rest, **kw)
    assert (r1 is ours) == (r2 is theirs)
    np.testing.assert_array_equal(ours, theirs)
    return ours, theirs


BOX_CASES = [
    dict(args=(0.25, 0.25, 0.75, 0.75)),
    dict(args=(10, 10, 30, 40), kw=dict(use_normalized_coordinates=False, thickness=1)),
    dict(args=(0.4, 0.1, 0.9, 0.9), kw=dict(display_str_list=["face: 87%"])),
    dict(args=(0.0, 0.0, 1.0, 1.0), kw=dict(thickness=4, color=(0, 0, 0))),
    dict(args=(0.9, 0.8, 0.1, 0.2), kw=dict(display_str_list=["a", "two lines", "x: 1%"])),
    dict(args=(-5, -5, 500, 700), kw=dict(use_normalized_coordinates=False,
                                          display_str_list=["off the image"])),
    dict(args=(0.02, 0.5, 0.3, 0.99), kw=dict(display_str_list=["top edge"], thickness=3)),
]


@pytest.mark.parametrize("case", BOX_CASES, ids=[str(i) for i in range(len(BOX_CASES))])
def test_bounding_box_matches(case):
    both("draw_bounding_box_on_image_array", _img(96, 96), *case["args"],
         **case.get("kw", {}))


def test_bounding_boxes_and_bad_shape_match():
    boxes = np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9], [0.2, 0.6, 0.3, 0.95]])
    both("draw_bounding_boxes_on_image_array", _img(), boxes)
    both("draw_bounding_boxes_on_image_array", _img(), boxes, (1, 2, 3), 3,
         [["one"], [], ["three", "3"]])
    for mod in (viz, jviz):
        with pytest.raises(ValueError):
            mod.draw_bounding_boxes_on_image_array(_img(), np.zeros((2, 3)))


def test_keypoints_match():
    both("draw_keypoints_on_image_array", _img(), [(0.5, 0.5), (0.25, 0.75)])
    both("draw_keypoints_on_image_array", _img(), [(0.0, 0.0), (1.0, 1.0)], radius=4)
    both("draw_keypoints_on_image_array", _img(), [(3, 60), (47, 2)], (1, 2, 3), 1, False)


def test_mask_matches():
    mask = (np.random.RandomState(1).rand(48, 64) > 0.6).astype(np.uint8)
    both("draw_mask_on_image_array", _img(), mask)
    both("draw_mask_on_image_array", _img(), mask, (255, 0, 0), 0.5)
    for mod in (viz, jviz):
        with pytest.raises(ValueError):
            mod.draw_mask_on_image_array(_img(), np.zeros((8, 8), np.uint8))
        with pytest.raises(ValueError):
            mod.draw_mask_on_image_array(_img(), np.zeros((48, 64), np.float32))


@pytest.mark.parametrize("scores", [None, "some", "all"])
def test_visualize_boxes_and_labels_matches(scores):
    rng = np.random.RandomState(2)
    n = 25
    ymin, xmin = rng.uniform(0, 0.6, (2, n))
    boxes = np.stack([ymin, xmin, ymin + rng.uniform(0.1, 0.4, n),
                      xmin + rng.uniform(0.1, 0.4, n)], axis=1)
    boxes[3] = boxes[1]  # two labels on one box
    classes = rng.randint(1, 13, n)
    index = {i: {"id": i, "name": f"class{i}"} for i in range(1, 12)}  # 12: N/A
    s = {None: None, "some": rng.uniform(0, 1, n), "all": np.ones(n)}[scores]
    both("visualize_boxes_and_labels_on_image_array", _img(120, 160), boxes, classes, s, index)
    both("visualize_boxes_and_labels_on_image_array", _img(120, 160), boxes * 100, classes, s,
         index, use_normalized_coordinates=False, max_boxes_to_draw=5, min_score_thresh=0.3,
         line_thickness=1)


@pytest.mark.parametrize("name", ["faces", "none"])
def test_mark_face_matches(name):
    img = (np.asarray(Image.open(FACES).convert("RGB"), np.uint8) if name == "faces"
           else np.zeros((64, 64, 3), np.uint8))
    ours, found = face_detection.FaceDetector().mark_face(img)
    theirs, jfound = jface.FaceDetector(haar.DEFAULT_CASCADE_PATH).mark_face(img)
    assert found is jfound is (name == "faces")
    assert ours.dtype == np.uint8 and ours.shape == img.shape
    np.testing.assert_array_equal(ours, theirs)
    assert (ours != img).any() == found


PBTXT = """
item {
  id: 1
  name: 'face'
  display_name: "human face"
}
item {
  id: 2
  name: 'cat'
}
item { id: 2 name: "dup" }
item { id: 7 name: 'far' }
"""


def test_label_maps_match(tmp_path):
    p = tmp_path / "labels.pbtxt"
    p.write_text(PBTXT)
    lm = viz.load_labelmap(str(p))
    assert lm == jviz.load_labelmap(str(p))
    for max_classes in (1, 2, 10):
        for display in (True, False):
            cats = viz.convert_label_map_to_categories(lm, max_classes, display)
            assert cats == jviz.convert_label_map_to_categories(lm, max_classes, display)
            assert viz.create_category_index(cats) == jviz.create_category_index(cats)
    bad = tmp_path / "bad.pbtxt"
    for text in ("item { id: 0 name: 'background' }", "item { name: 'no id' }"):
        bad.write_text(text)
        for mod in (viz, jviz):
            with pytest.raises(ValueError):
                mod.load_labelmap(str(bad))


def test_base64_helpers(monkeypatch):
    img = _img(20, 24)
    ours = image_io.numpy_to_base64(img)
    assert ours.startswith("data:image/PNG;base64,")
    theirs = jimage_io.numpy_to_base64(img)
    for uri in (ours, theirs, theirs.split(",", 1)[1]):
        back = image_io.base64_to_numpy(uri)
        np.testing.assert_array_equal(back, img)
        np.testing.assert_array_equal(back, jimage_io.base64_to_numpy(uri))
        assert back.flags.writeable
    jpeg = image_io.numpy_to_base64(img, "JPEG")
    assert jpeg.startswith("data:image/JPEG;base64,")
    np.testing.assert_array_equal(image_io.base64_to_numpy(jpeg),
                                  jimage_io.base64_to_numpy(jpeg))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(image_io.base64_to_numpy(image_io.numpy_to_base64(img)), img)
    with pytest.raises(ImportError, match="non-PNG image needs PIL"):
        image_io.base64_to_numpy(jpeg)


def test_labels_without_pil_raise_and_the_rest_draws(monkeypatch):
    expected = _img()
    jviz.draw_bounding_box_on_image_array(expected, 0.1, 0.1, 0.8, 0.8)
    jviz.draw_keypoints_on_image_array(expected, [(0.5, 0.5)])
    faces = np.asarray(Image.open(FACES).convert("RGB"), np.uint8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = _img()
    viz.draw_bounding_box_on_image_array(img, 0.1, 0.1, 0.8, 0.8)
    viz.draw_keypoints_on_image_array(img, [(0.5, 0.5)])
    np.testing.assert_array_equal(img, expected)
    with pytest.raises(ImportError, match="needs PIL"):
        viz.draw_bounding_box_on_image_array(img, 0.1, 0.1, 0.8, 0.8, display_str_list=["x"])
    with pytest.raises(ImportError, match="needs PIL"):
        face_detection.FaceDetector().mark_face(faces)
    marked, found = face_detection.FaceDetector().mark_face(np.zeros((64, 64, 3), np.uint8))
    assert not found and not marked.any()
