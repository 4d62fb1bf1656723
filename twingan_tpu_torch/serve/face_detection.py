"""Face detection and cropping for the serving pipeline.

Counterpart of ``twingan_tpu/serve/face_detection.py``: the reference's
empirical crop expansion (left/right 0.5x, top 1.0x, bottom 0.3x of the
detected box), the square crop, the max-faces cap, the ``detect_face``
preview, and the process pool, over the port's Haar detector
(``serve/haar.py``) and drawing (``utils/visualization.py``). The detector
runs on the host in numpy, as in the JAX package.

One deliberate difference: the JAX ``FaceDetector`` serves whole images
when its cascade file is missing or malformed (``available`` false); the
port's cascade ships with the package, and a cascade path that cannot be
loaded raises here instead of quietly losing the detector. ``available``
stays for callers of the JAX interface. When the detector finds no face,
``crop_faces`` still serves the whole (center-squared) image, as the
reference does.

The module imports numpy and ``serve/haar.py`` only, never torch: the pool
workers (``spawn``) import just this module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from twingan_tpu_torch.serve.haar import HaarFaceDetector

# Reference empirical expansion ratios.
WIDTH_EXPAND_LEFT = 0.5
WIDTH_EXPAND_RIGHT = 0.5
HEIGHT_EXPAND_TOP = 1.0
HEIGHT_EXPAND_BOTTOM = 0.3


def _rgb_to_gray(image: np.ndarray) -> np.ndarray:
    return image @ np.asarray([0.299, 0.587, 0.114], np.float32)


def expand_box(x: int, y: int, w: int, h: int, img_w: int,
               img_h: int) -> tuple[int, int, int, int]:
    """Apply the reference crop expansion and clamp to the image;
    returns (x0, y0, x1, y1)."""
    x0 = int(max(0, x - w * WIDTH_EXPAND_LEFT))
    x1 = int(min(img_w, x + w * (1 + WIDTH_EXPAND_RIGHT)))
    y0 = int(max(0, y - h * HEIGHT_EXPAND_TOP))
    y1 = int(min(img_h, y + h * (1 + HEIGHT_EXPAND_BOTTOM)))
    return x0, y0, x1, y1


def square_crop(box: tuple[int, int, int, int], img_w: int,
                img_h: int) -> tuple[int, int, int, int]:
    """Grow the expanded box to a centered square clamped to the image
    (the translate models take square inputs)."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    size = min(max(w, h), img_w, img_h)
    cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
    x0 = int(np.clip(cx - size // 2, 0, img_w - size))
    y0 = int(np.clip(cy - size // 2, 0, img_h - size))
    return x0, y0, x0 + size, y0 + size


class FaceDetector:
    """Detects, expands, and square-crops faces (at most ``max_faces``, as
    the reference serves at most 4 a request)."""

    def __init__(self, cascade_path: Optional[str] = None, max_faces: int = 4):
        self.max_faces = max_faces
        self._detector = HaarFaceDetector(cascade_path)

    @property
    def available(self) -> bool:
        return self._detector is not None

    def detect(self, image: np.ndarray) -> list[tuple[int, int, int, int]]:
        """Returns square crop boxes (x0, y0, x1, y1), largest first."""
        h, w = image.shape[:2]
        boxes = [square_crop(expand_box(x, y, fw, fh, w, h), w, h)
                 for (x, y, fw, fh) in self.raw_boxes(image)]
        boxes.sort(key=lambda b: (b[2] - b[0]) * (b[3] - b[1]), reverse=True)
        return boxes[: self.max_faces]

    def raw_boxes(self, image: np.ndarray) -> list[tuple[int, int, int, int]]:
        """Unexpanded detections as (x, y, w, h), detector order: the one
        detector call that both ``detect`` (the crops) and ``mark_face``
        (the preview) build on."""
        gray = _rgb_to_gray(np.asarray(image, np.float32))
        faces = self._detector.detect(gray, min_neighbors=3,
                                      min_size=max(24, min(image.shape[:2]) // 10))
        return [tuple(int(v) for v in f) for f in faces]

    def mark_face(self, image: np.ndarray) -> tuple[np.ndarray, bool]:
        """Returns (annotated uint8 copy, face_found): the reference's
        detectFace preview. The Haar cascade has no calibrated confidence,
        so boxes are labelled 'face' without a score; the label's text
        needs PIL (``utils/visualization.py:_draw_label_strings``)."""
        from twingan_tpu_torch.utils.visualization import (
            visualize_boxes_and_labels_on_image_array,
        )

        marked = np.array(image, np.uint8)  # always a fresh copy
        faces = self.raw_boxes(image)
        if faces:
            h, w = image.shape[:2]
            boxes = np.asarray([[y / h, x / w, (y + fh) / h, (x + fw) / w]
                                for (x, y, fw, fh) in faces], np.float32)
            visualize_boxes_and_labels_on_image_array(
                marked, boxes, np.ones(len(faces), np.int32), None,
                {1: {"id": 1, "name": "face"}})
        return marked, bool(faces)

    def crop_faces(self, image: np.ndarray) -> list[np.ndarray]:
        """Cropped face images; the full (center-squared) image when no
        face is found, as the reference serves whole images then."""
        boxes = self.detect(image)
        if not boxes:
            h, w = image.shape[:2]
            boxes = [square_crop((0, 0, w, h), w, h)]
        return [image[y0:y1, x0:x1] for (x0, y0, x1, y1) in boxes]

    def close(self) -> None:
        """Release detector resources (nothing for the in-process detector)."""


# ---------------------------------------------------------------------- #
# Process-pool detection: the Haar sweep is numpy on one core, and
# concurrent HTTP requests would otherwise serialize on it. The pool runs
# only the raw_boxes() sweep in worker processes; expansion, square-crop
# and drawing stay in the FaceDetector methods.
# ---------------------------------------------------------------------- #
_POOL_DETECTOR: Optional[FaceDetector] = None


def _pool_init(cascade_path: Optional[str]) -> None:
    global _POOL_DETECTOR
    _POOL_DETECTOR = FaceDetector(cascade_path)


def _pool_raw_boxes(image: np.ndarray) -> list[tuple[int, int, int, int]]:
    assert _POOL_DETECTOR is not None
    return _POOL_DETECTOR.raw_boxes(image)


class PooledFaceDetector(FaceDetector):
    """FaceDetector whose cascade sweep runs in a process pool.

    Concurrent requests (ThreadingHTTPServer threads) each block in
    ``Pool.apply``, so up to ``num_procs`` detections proceed in parallel
    on separate cores. Workers use the ``spawn`` context: they import only
    numpy and this module with the haar module, never the parent's torch
    or CUDA state."""

    def __init__(self, num_procs: int = 2, cascade_path: Optional[str] = None,
                 max_faces: int = 4):
        super().__init__(cascade_path, max_faces)
        import multiprocessing as mp

        self._pool = None
        if num_procs > 0:
            self._pool = mp.get_context("spawn").Pool(num_procs, initializer=_pool_init,
                                                      initargs=(cascade_path,))

    def raw_boxes(self, image: np.ndarray) -> list[tuple[int, int, int, int]]:
        if self._pool is None:
            return super().raw_boxes(image)
        return self._pool.apply(_pool_raw_boxes, (np.ascontiguousarray(image),))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
