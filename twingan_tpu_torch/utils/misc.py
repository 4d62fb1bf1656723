"""Miscellaneous helpers.

Counterpart of ``twingan_tpu/utils/misc.py``, whole:

- ``safe_one_hot_encoding``: out-of-range labels give all-zero rows;
- ``grayscale_to_heatmap``: the blue-to-red colormap of debug images;
- ``get_random_patches``: random square patches from a batch; the draws
  come from a ``torch.Generator`` (``draw_patch_origins``) or are injected;
- ``combine_dicts``: end-point namespacing;
- ``get_tags_dict`` and ``process_anime_face_labels``: the tag files and
  the mutually exclusive tag-group filter of the tagger's tag mode;
- ``box_iou``, ``box_contains`` and ``find_boundary``: face-box geometry and
  a binary search over a monotone predicate.

The file and box helpers are plain Python, as in the JAX module.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F


def safe_one_hot_encoding(labels: torch.Tensor, num_classes: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hot rows of integer labels; out-of-range labels give all-zero rows."""
    labels = torch.as_tensor(labels).long()
    valid = (labels >= 0) & (labels < num_classes)
    hot = F.one_hot(torch.where(valid, labels, torch.zeros_like(labels)), num_classes)
    return hot.to(dtype) * valid.to(dtype)[..., None]


def grayscale_to_heatmap(gray: torch.Tensor, is_bgr: bool = False) -> torch.Tensor:
    """[..., 1] grayscale in [0, 1] -> RGB jet heatmap (blue low, red high)."""
    g = torch.clamp(gray[..., 0] if gray.shape[-1] == 1 else gray, 0.0, 1.0)
    r = torch.clamp(torch.minimum(4.0 * g - 1.5, -4.0 * g + 4.5), 0.0, 1.0)
    green = torch.clamp(torch.minimum(4.0 * g - 0.5, -4.0 * g + 3.5), 0.0, 1.0)
    b = torch.clamp(torch.minimum(4.0 * g + 0.5, -4.0 * g + 2.5), 0.0, 1.0)
    channels = [b, green, r] if is_bgr else [r, green, b]
    return torch.stack(channels, dim=-1)


def draw_patch_origins(shape, patch_hw: int, num_patches: int,
                       generator: torch.Generator) -> tuple[torch.Tensor, ...]:
    """(batch index, y, x) of ``num_patches`` patches of a [B, H, W, C]
    batch, each uniform over its range."""
    b, h, w = shape[0], shape[1], shape[2]
    dev = generator.device
    bi = torch.randint(0, b, (num_patches,), generator=generator, device=dev)
    ys = torch.randint(0, h - patch_hw + 1, (num_patches,), generator=generator, device=dev)
    xs = torch.randint(0, w - patch_hw + 1, (num_patches,), generator=generator, device=dev)
    return bi, ys, xs


def get_random_patches(images: torch.Tensor, patch_hw: int, num_patches: int,
                       generator: Optional[torch.Generator] = None,
                       origins: Optional[tuple] = None) -> torch.Tensor:
    """[N, patch_hw, patch_hw, C] random patches of an NHWC batch, at
    ``origins`` (batch index, y, x) or at origins drawn from ``generator``."""
    if origins is None:
        origins = draw_patch_origins(images.shape, patch_hw, num_patches, generator)
    bi, ys, xs = (torch.as_tensor(o).long().tolist() for o in origins)
    return torch.stack([images[i, y:y + patch_hw, x:x + patch_hw]
                        for i, y, x in zip(bi, ys, xs)])


def combine_dicts(dict_of_dicts: Mapping[str, Mapping[str, object]]) -> Dict[str, object]:
    """{'gen': {'output': x}} -> {'gen_output': x} (end-point namespacing)."""
    out: Dict[str, object] = {}
    for prefix, sub in dict_of_dicts.items():
        for k, v in sub.items():
            out[f"{prefix}_{k}"] = v
    return out


def get_tags_dict(path: str, key_column_index=0, value_column_index=2) -> dict:
    """Tab-separated file -> {key column (or line number): value column (or
    whole line)}; blank lines are skipped."""
    ret = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            whole = line.rstrip("\n")
            content = whole.split("\t")
            key = i if key_column_index is None else int(content[key_column_index])
            val = whole if value_column_index is None else content[value_column_index]
            ret[key] = val
    return ret


def process_anime_face_labels(labels, classification_threshold: float,
                              labels_id_to_group: dict) -> list:
    """Mutually exclusive tag-group filter: keep only the best label within
    each group, and nothing at all unless both hair colour (group '2') and
    eye colour (group '3') clear the threshold."""
    ret = [0.0] * len(labels)
    group_vals: dict = {}
    for i, val in enumerate(labels):
        group = labels_id_to_group.get(i)
        if group is not None:
            group_vals.setdefault(group, []).append((i, float(val)))
    hair_color_missing = True
    eye_color_missing = True
    for group, vals in group_vals.items():
        idx, best = max(vals, key=lambda x: x[1])
        ret[idx] = best
        if group == "2" and best >= classification_threshold:
            hair_color_missing = False
        if group == "3" and best >= classification_threshold:
            eye_color_missing = False
    if hair_color_missing or eye_color_missing:
        return [0.0] * len(labels)
    return ret


def box_iou(a, b) -> float:
    """IoU of two (x0, y0, x1, y1) boxes."""
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix = max(0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union if union > 0 else 0.0


def box_contains(outer, inner) -> bool:
    return (outer[0] <= inner[0] and outer[1] <= inner[1]
            and outer[2] >= inner[2] and outer[3] >= inner[3])


def find_boundary(predicate: Callable[[int], bool], lo: int, hi: int) -> int:
    """Smallest x in [lo, hi] with predicate(x) True, assuming monotonicity;
    hi + 1 if none."""
    result = hi + 1
    while lo <= hi:
        mid = (lo + hi) // 2
        if predicate(mid):
            result = mid
            hi = mid - 1
        else:
            lo = mid + 1
    return result
