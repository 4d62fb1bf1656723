"""Detection visualization and label-map utilities.

Counterpart of ``twingan_tpu/utils/visualization.py``, function for
function: label maps (pbtxt, parsed without protobuf), boxes, keypoints,
masks and ``visualize_boxes_and_labels_on_image_array``. Every drawing is
a numpy write into a uint8 RGB array, bit-equal to the JAX package's, but
the label text: ``_draw_label_strings`` measures and draws it with PIL's
default font, imported inside that function, and raises ``ImportError``
naming PIL where PIL is not installed. So the server's
``detect_face`` preview, which labels its boxes "face", needs PIL.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# A small rotation of visually-distinct colors; classes index into it
# (the reference rotates a 140-name CSS palette the same way).
PALETTE = (
    (230, 60, 60), (60, 180, 75), (65, 105, 225), (255, 200, 40),
    (170, 110, 40), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (0, 128, 128),
)


# --------------------------------------------------------------------------- #
# Label maps (pbtxt)
# --------------------------------------------------------------------------- #

_ITEM_RE = re.compile(r"item\s*\{([^}]*)\}", re.S)
_FIELD_RE = re.compile(r"(\w+)\s*:\s*(?:'([^']*)'|\"([^\"]*)\"|(\S+))")


def load_labelmap(path: str) -> List[dict]:
    """Parses a StringIntLabelMap pbtxt into a list of item dicts with
    keys id / name / display_name (display_name optional)."""
    with open(path) as f:
        text = f.read()
    items = []
    for m in _ITEM_RE.finditer(text):
        item: dict = {}
        for fm in _FIELD_RE.finditer(m.group(1)):
            key = fm.group(1)
            val = fm.group(2) or fm.group(3) or fm.group(4)
            item[key] = int(val) if key == "id" else val
        if "id" not in item:
            raise ValueError(f"label map item without id in {path}")
        if item["id"] < 1:
            # Reference _validate_label_map: ids must be >= 1 (0 = background).
            raise ValueError("Label map ids should be >= 1.")
        items.append(item)
    return items


def convert_label_map_to_categories(
    label_map: List[dict], max_num_classes: int, use_display_name: bool = True
) -> List[dict]:
    """COCO-style category dicts [{'id': int, 'name': str}, ...]."""
    categories = []
    seen = set()
    for item in label_map:
        if not 0 < item["id"] <= max_num_classes:
            continue
        if item["id"] in seen:
            continue
        seen.add(item["id"])
        name = (
            item.get("display_name")
            if use_display_name and item.get("display_name")
            else item.get("name", f"category_{item['id']}")
        )
        categories.append({"id": item["id"], "name": name})
    return categories


def create_category_index(categories: List[dict]) -> Dict[int, dict]:
    return {cat["id"]: cat for cat in categories}


# --------------------------------------------------------------------------- #
# Drawing primitives
# --------------------------------------------------------------------------- #


def _to_pixels(
    ymin: float, xmin: float, ymax: float, xmax: float, h: int, w: int,
    normalized: bool,
) -> tuple[int, int, int, int]:
    if normalized:
        ymin, xmin, ymax, xmax = ymin * h, xmin * w, ymax * h, xmax * w
    return int(round(ymin)), int(round(xmin)), int(round(ymax)), int(round(xmax))


def draw_bounding_box_on_image_array(
    image: np.ndarray,
    ymin: float,
    xmin: float,
    ymax: float,
    xmax: float,
    color: tuple = PALETTE[0],
    thickness: int = 2,
    display_str_list: Sequence[str] = (),
    use_normalized_coordinates: bool = True,
) -> np.ndarray:
    """Draws one box (+ stacked label strings above/below it) in place."""
    h, w = image.shape[:2]
    y0, x0, y1, x1 = _to_pixels(ymin, xmin, ymax, xmax, h, w,
                                use_normalized_coordinates)
    y0, y1 = sorted((max(0, min(h - 1, y0)), max(0, min(h - 1, y1))))
    x0, x1 = sorted((max(0, min(w - 1, x0)), max(0, min(w - 1, x1))))
    c = np.asarray(color, np.uint8)
    for t in range(thickness):
        yy0, yy1 = min(h - 1, y0 + t), max(0, y1 - t)
        xx0, xx1 = min(w - 1, x0 + t), max(0, x1 - t)
        image[yy0, x0 : x1 + 1] = c
        image[yy1, x0 : x1 + 1] = c
        image[y0 : y1 + 1, xx0] = c
        image[y0 : y1 + 1, xx1] = c
    if display_str_list:
        _draw_label_strings(image, y0, x0, list(display_str_list), color)
    return image


def _draw_label_strings(
    image: np.ndarray, top: int, left: int, strings: List[str], color: tuple
) -> None:
    """Stacks label boxes upward from the box top (downward if no room),
    like the reference's ``text_bottom`` walk. The text is PIL's default
    font: without PIL this raises ``ImportError``."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError("drawing label text needs PIL (its default font), which is not "
                          "installed; boxes, keypoints and masks draw without it") from e

    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    font = ImageFont.load_default()
    heights = []
    for s in strings:
        bb = draw.textbbox((0, 0), s, font=font)
        heights.append((bb[2] - bb[0] + 8, bb[3] - bb[1] + 6))
    total = sum(hh for _, hh in heights)
    text_bottom = top if top > total else top + total
    for s, (tw, th) in zip(strings[::-1], heights[::-1]):
        draw.rectangle(
            [(left, text_bottom - th), (left + tw, text_bottom)], fill=tuple(color)
        )
        draw.text((left + 4, text_bottom - th + 2), s, fill="black", font=font)
        text_bottom -= th
    image[:] = np.asarray(pil, np.uint8)


def draw_bounding_boxes_on_image_array(
    image: np.ndarray,
    boxes: np.ndarray,
    color: tuple = PALETTE[0],
    thickness: int = 2,
    display_str_list_list: Optional[Sequence[Sequence[str]]] = None,
) -> np.ndarray:
    """boxes: [N, 4] of (ymin, xmin, ymax, xmax), normalized."""
    boxes = np.asarray(boxes)
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be [N, 4], got {boxes.shape}")
    for i, (ymin, xmin, ymax, xmax) in enumerate(boxes):
        strs = (
            display_str_list_list[i]
            if display_str_list_list is not None and i < len(display_str_list_list)
            else ()
        )
        draw_bounding_box_on_image_array(
            image, ymin, xmin, ymax, xmax, color, thickness, strs
        )
    return image


def draw_keypoints_on_image_array(
    image: np.ndarray,
    keypoints: Sequence[tuple],
    color: tuple = PALETTE[1],
    radius: int = 2,
    use_normalized_coordinates: bool = True,
) -> np.ndarray:
    """keypoints: sequence of (y, x). Draws filled discs in place."""
    h, w = image.shape[:2]
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disc = (yy**2 + xx**2) <= radius**2
    c = np.asarray(color, np.uint8)
    for (ky, kx) in keypoints:
        if use_normalized_coordinates:
            ky, kx = ky * h, kx * w
        ky, kx = int(round(ky)), int(round(kx))
        y0, y1 = max(0, ky - radius), min(h, ky + radius + 1)
        x0, x1 = max(0, kx - radius), min(w, kx + radius + 1)
        sub = disc[y0 - (ky - radius) : y1 - (ky - radius),
                   x0 - (kx - radius) : x1 - (kx - radius)]
        region = image[y0:y1, x0:x1]
        region[sub] = c
    return image


def draw_mask_on_image_array(
    image: np.ndarray, mask: np.ndarray, color: tuple = PALETTE[0],
    alpha: float = 0.7,
) -> np.ndarray:
    """Alpha-blends ``color`` into image where mask==1 (uint8 {0,1} mask)."""
    if image.shape[:2] != mask.shape[:2]:
        raise ValueError(f"mask shape {mask.shape} != image {image.shape[:2]}")
    if mask.dtype != np.uint8:
        raise ValueError(f"mask must be uint8, got {mask.dtype}")
    m = (mask > 0)[..., None].astype(np.float32) * alpha
    c = np.asarray(color, np.float32)
    image[:] = np.clip(
        image.astype(np.float32) * (1.0 - m) + c * m, 0, 255
    ).astype(np.uint8)
    return image


# --------------------------------------------------------------------------- #
# Detection overlay
# --------------------------------------------------------------------------- #


def visualize_boxes_and_labels_on_image_array(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    scores: Optional[np.ndarray],
    category_index: Dict[int, dict],
    use_normalized_coordinates: bool = True,
    max_boxes_to_draw: int = 20,
    min_score_thresh: float = 0.5,
    line_thickness: int = 2,
) -> np.ndarray:
    """Groups boxes above threshold and overlays 'name: NN%' labels; color is
    keyed by class. scores=None draws all boxes as groundtruth (black)."""
    box_to_strs: dict = collections.defaultdict(list)
    box_to_color: dict = {}
    boxes = np.asarray(boxes).reshape(-1, 4)
    for i in range(min(max_boxes_to_draw or boxes.shape[0], boxes.shape[0])):
        if scores is not None and scores[i] < min_score_thresh:
            continue
        box = tuple(boxes[i].tolist())
        cls = int(np.asarray(classes).reshape(-1)[i])
        name = category_index.get(cls, {}).get("name", "N/A")
        if scores is None:
            box_to_strs[box].append(name)
            box_to_color[box] = (0, 0, 0)
        else:
            box_to_strs[box].append(f"{name}: {int(100 * scores[i])}%")
            box_to_color[box] = PALETTE[cls % len(PALETTE)]
    for box, color in box_to_color.items():
        ymin, xmin, ymax, xmax = box
        draw_bounding_box_on_image_array(
            image, ymin, xmin, ymax, xmax, color, line_thickness,
            box_to_strs[box], use_normalized_coordinates,
        )
    return image
