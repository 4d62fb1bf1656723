"""Viola-Jones Haar-cascade face detector (numpy, vectorized over windows).

Counterpart of ``twingan_tpu/serve/haar.py``: the parser for OpenCV's
stump-based 'opencv-cascade-classifier' XML format, the integral images,
the window sweep, ``group_rectangles`` and ``HaarFaceDetector``, with the
same arithmetic. Two things differ:

- the cascade ships with the package (``cascades/``, OpenCV's
  ``haarcascade_frontalface_default.xml`` unchanged, its Intel licence
  header included) and is the default, so the detector never goes missing
  on a machine without OpenCV; an explicit path that does not exist raises
  ``FileNotFoundError``;
- the pre-shrink of large inputs and every pyramid level resize through
  ``data/resample.py:pil_bilinear_resize_f32``, Pillow's mode "F" bilinear
  filter in numpy, bit for bit, where the JAX package calls PIL.

Evaluation follows OpenCV's HaarEvaluator semantics:
    inv_area   = 1 / (window_w * window_h)
    mean       = window_sum * inv_area
    var_norm   = sqrt(max(window_sqsum * inv_area - mean^2, 0)) or 1
    feat_value = sum_i(weight_i * rect_sum_i) * inv_area
    stump      -> leaf[feat_value >= threshold * var_norm]
    stage fails when sum(leaves) < stage_threshold
with a downscaling image pyramid and groupRectangles-style min-neighbors
clustering. The module imports numpy and the resample module only (no
torch), so that the pooled detector's worker processes start quickly.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from twingan_tpu_torch.data.resample import pil_bilinear_resize_f32

DEFAULT_CASCADE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cascades",
                                    "haarcascade_frontalface_default.xml")


class HaarCascade:
    def __init__(self, path: str):
        root = ET.parse(path).getroot()
        cascade = root.find("cascade")
        if cascade is None or cascade.get("type_id") != "opencv-cascade-classifier":
            raise ValueError(f"{path}: only the new stump cascade format is supported")
        self.height = int(cascade.findtext("height"))
        self.width = int(cascade.findtext("width"))

        # Features: up to 3 rects of (x, y, w, h, weight).
        feats = []
        for feat in cascade.find("features"):
            rects = []
            for r in feat.find("rects"):
                rects.append([float(v) for v in r.text.split()])
            while len(rects) < 3:
                rects.append([0.0, 0.0, 0.0, 0.0, 0.0])
            feats.append(rects[:3])
        self.rects = np.asarray(feats, np.float32)  # [F, 3, 5]

        # Stages of stumps.
        self.stages = []
        for stage in cascade.find("stages"):
            threshold = float(stage.findtext("stageThreshold"))
            f_idx, s_thresh, leaves = [], [], []
            for weak in stage.find("weakClassifiers"):
                nodes = weak.findtext("internalNodes").split()
                lv = weak.findtext("leafValues").split()
                if nodes[0] != "0" or nodes[1] != "-1":
                    raise ValueError(f"{path}: a weak classifier is not a stump")
                f_idx.append(int(nodes[2]))
                s_thresh.append(float(nodes[3]))
                leaves.append([float(lv[0]), float(lv[1])])
            self.stages.append((threshold, np.asarray(f_idx, np.int32),
                                np.asarray(s_thresh, np.float32),
                                np.asarray(leaves, np.float32)))


def _integral(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    img = img.astype(np.float64)
    ii = np.zeros((img.shape[0] + 1, img.shape[1] + 1))
    ii[1:, 1:] = img.cumsum(0).cumsum(1)
    sq = np.zeros_like(ii)
    sq[1:, 1:] = (img * img).cumsum(0).cumsum(1)
    return ii, sq


def _rect_sums(ii: np.ndarray, ys: np.ndarray, xs: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """Sum of each window-relative rect for every window.

    ys/xs: [W] window origins; rects: [K, 4] ints (x, y, w, h). Returns
    [W, K]. Every corner of a window-relative rect is origin_flat +
    constant_offset, so the four gathers are 1-D takes at [W,1]+[1,K]
    broadcast sums (the cascade evaluates ~10^6 rect sums per image)."""
    stride = ii.shape[1]
    flat = ii.ravel()
    base = ys.astype(np.int64) * stride + xs.astype(np.int64)  # [W]
    x0 = rects[:, 0].astype(np.int64)
    y0 = rects[:, 1].astype(np.int64)
    x1 = x0 + rects[:, 2]
    y1 = y0 + rects[:, 3]
    b = base[:, None]
    return (flat[b + (y1 * stride + x1)[None, :]]
            - flat[b + (y0 * stride + x1)[None, :]]
            - flat[b + (y1 * stride + x0)[None, :]]
            + flat[b + (y0 * stride + x0)[None, :]])


def _detect_single_scale(cascade: HaarCascade, gray: np.ndarray, step: int) -> np.ndarray:
    h, w = gray.shape
    wh, ww = cascade.height, cascade.width
    if h < wh or w < ww:
        return np.zeros((0, 2), np.int32)
    ii, sq = _integral(gray)
    ys, xs = np.meshgrid(np.arange(0, h - wh + 1, step), np.arange(0, w - ww + 1, step),
                         indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)

    inv_area = 1.0 / (wh * ww)
    win = np.asarray([[0, 0, ww, wh]], np.int32)
    sums = _rect_sums(ii, ys, xs, win)[:, 0]
    sqs = _rect_sums(sq, ys, xs, win)[:, 0]
    mean = sums * inv_area
    variance = sqs * inv_area - mean * mean
    var_norm = np.where(variance > 0, np.sqrt(np.maximum(variance, 0)), 1.0)

    alive = np.arange(len(ys))
    for threshold, f_idx, s_thresh, leaves in cascade.stages:
        if len(alive) == 0:
            break
        ya, xa = ys[alive], xs[alive]
        rects = cascade.rects[f_idx]  # [S, 3, 5]
        # [W, S] weighted rect sums: the three rect slots of every stump in
        # one gather (the parser's zero-weight padding adds nothing).
        s = len(f_idx)
        flat_rects = rects[:, :, :4].reshape(s * 3, 4).astype(np.int32)
        weights = rects[:, :, 4].reshape(s * 3)
        sums3 = _rect_sums(ii, ya, xa, flat_rects)  # [W, S*3]
        vals = (sums3 * weights[None, :]).reshape(len(alive), s, 3).sum(axis=2)
        vals *= inv_area
        chosen = np.where(vals < s_thresh[None, :] * var_norm[alive][:, None],
                          leaves[None, :, 0], leaves[None, :, 1])
        stage_sum = chosen.sum(axis=1)
        alive = alive[stage_sum >= threshold]
    return np.stack([xs[alive], ys[alive]], axis=1) if len(alive) else np.zeros((0, 2), np.int32)


def group_rectangles(boxes: np.ndarray, min_neighbors: int = 3, eps: float = 0.2) -> np.ndarray:
    """OpenCV groupRectangles-style clustering: boxes are similar when all
    coordinate deltas are within eps * mean size; clusters below
    min_neighbors are discarded; survivors are averaged."""
    if len(boxes) == 0:
        return boxes
    boxes = boxes.astype(np.float64)
    parent = np.arange(len(boxes))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(len(boxes)):
        for j in range(i + 1, len(boxes)):
            delta = eps * 0.5 * (boxes[i, 2] + boxes[j, 2])
            if (np.abs(boxes[i] - boxes[j]) <= delta).all():
                parent[find(i)] = find(j)
    clusters: dict[int, list[int]] = {}
    for i in range(len(boxes)):
        clusters.setdefault(find(i), []).append(i)
    out = [boxes[members].mean(axis=0) for members in clusters.values()
           if len(members) >= min_neighbors]
    return np.asarray(out, np.int32) if out else np.zeros((0, boxes.shape[1]), np.int32)


class HaarFaceDetector:
    """Multi-scale detector over a cascade file (the bundled frontal-face
    cascade by default). detectMultiScale-compatible output: [N, 4] boxes
    (x, y, w, h) in the input image."""

    def __init__(self, cascade_path: Optional[str] = None):
        cascade_path = cascade_path or DEFAULT_CASCADE_PATH
        if not os.path.exists(cascade_path):
            raise FileNotFoundError(f"no haar cascade xml at {cascade_path}")
        self.cascade = HaarCascade(cascade_path)

    def detect(self, gray: np.ndarray, scale_factor: float = 1.2, min_neighbors: int = 3,
               min_size: int = 24, step: int = 2, max_side: int = 512) -> np.ndarray:
        gray = np.asarray(gray, np.float32)
        # Bound work on huge inputs; rescale results back.
        pre = 1.0
        if max(gray.shape) > max_side:
            pre = max_side / max(gray.shape)
            gray = pil_bilinear_resize_f32(gray, int(gray.shape[0] * pre),
                                           int(gray.shape[1] * pre))

        boxes = []
        scale = max(1.0, min_size / self.cascade.width)
        while True:
            sh = int(gray.shape[0] / scale)
            sw = int(gray.shape[1] / scale)
            if sh < self.cascade.height or sw < self.cascade.width:
                break
            hits = _detect_single_scale(self.cascade, pil_bilinear_resize_f32(gray, sh, sw),
                                        step)
            for x, y in hits:
                boxes.append([x * scale, y * scale, self.cascade.width * scale,
                              self.cascade.height * scale])
            scale *= scale_factor
        grouped = group_rectangles(np.asarray(boxes, np.float64).reshape(-1, 4), min_neighbors)
        return (grouped / pre).astype(np.int32) if len(grouped) else grouped
