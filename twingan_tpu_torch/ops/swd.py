"""Sliced Wasserstein Distance (SWD) eval metric on the device.

Counterpart of ``twingan_tpu/ops/swd.py``, the PGGAN paper's protocol:

1. a Laplacian pyramid of both image sets, levels res, res/2, ..., 16
   (5x5 binomial blur, SAME padding);
2. at each level ``patches_per_image`` random 7x7xC patch descriptors;
3. descriptors normalised by the per-channel mean and population std of
   their whole set, each set on its own (``+1e-8`` on the std);
4. projection onto ``random_projection_dim`` random unit directions
   (``+1e-12`` on each norm), a sort along the patch axis, and the mean
   |sorted_a - sorted_b|, averaged over ``random_sampling_count`` draws;
5. (real-vs-real-split, real-vs-fake) per level.

``sliced_wasserstein_distance`` holds both sets on the device at once;
``sliced_wasserstein_distance_chunked`` streams images through descriptor
extraction in chunks, gathers the descriptors in host memory (numpy
normalises them, as in the JAX package) and projects and sorts one level
and one draw at a time on the device.

The JAX functions draw patch positions and directions from PRNG keys.
Here every draw comes from an ``SWDDraws``: by default one CPU
``torch.Generator`` per draw, seeded from the run's seed and the draw's
tag, so the card and the CPU see the same numbers (they are made on the
CPU and moved to the device). A caller may pass its own ``SWDDraws``; the
tests pass one that re-derives the JAX package's draws from its key. The
tags:

- ``("patch", level, "real"|"fake")`` and ``("dirs", level, "rr"|"rf",
  repeat)`` in the one-shot path;
- ``("chunk_patch", set, first_image, level)`` and ``("chunk_dirs", level,
  "rr"|"rf", repeat)`` in the chunked one.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_GAUSS_5X5 = np.outer(_GAUSS_1D, _GAUSS_1D).astype(np.float32)

PATCH_SIZE = 7


class SWDDraws:
    """The random numbers of an SWD evaluation: patch positions and
    projection directions, each from a CPU generator seeded by
    (``seed``, tag)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _generator(self, tag) -> torch.Generator:
        return torch.Generator().manual_seed(zlib.crc32(repr((self.seed, tag)).encode()))

    def positions(self, tag, b: int, h: int, w: int, p: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-left corners (ys, xs), each int64 [b, p], of 7x7 patches in an
        h x w level."""
        g = self._generator(tag)
        ys = torch.randint(0, h - PATCH_SIZE + 1, (b, p), generator=g)
        xs = torch.randint(0, w - PATCH_SIZE + 1, (b, p), generator=g)
        return ys, xs

    def directions(self, tag, dim: int, proj: int) -> torch.Tensor:
        """float32 [dim, proj] standard normal directions (not yet unit)."""
        return torch.randn(dim, proj, generator=self._generator(tag))


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 5x5 binomial blur of NHWC ``x``, SAME padding."""
    c = x.shape[-1]
    k = torch.as_tensor(_GAUSS_5X5, dtype=x.dtype, device=x.device).expand(c, 1, 5, 5)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, padding=2, groups=c)
    return y.permute(0, 2, 3, 1)


def _pyr_down(x: torch.Tensor) -> torch.Tensor:
    return _blur(x)[:, ::2, ::2, :]


def _pyr_up(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    up = x.new_zeros((b, h * 2, w * 2, c))
    up[:, ::2, ::2, :] = x
    return _blur(up) * 4.0


def laplacian_pyramid(x: torch.Tensor, min_res: int = 16) -> list[torch.Tensor]:
    """Levels from the input resolution down to ``min_res`` (the last level
    is the low-pass residual), float32 NHWC."""
    levels = []
    cur = x.float()
    while cur.shape[1] > min_res:
        down = _pyr_down(cur)
        levels.append(cur - _pyr_up(down))
        cur = down
    levels.append(cur)
    return levels


def extract_patches(level: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """[B, P, 7, 7, C] patches of NHWC ``level`` at corners ys, xs [B, P]."""
    b = level.shape[0]
    offs = torch.arange(PATCH_SIZE, device=level.device)
    ys, xs = ys.to(level.device), xs.to(level.device)
    rows = (ys[:, :, None] + offs)[:, :, :, None]          # [B, P, 7, 1]
    cols = (xs[:, :, None] + offs)[:, :, None, :]          # [B, P, 1, 7]
    batch = torch.arange(b, device=level.device)[:, None, None, None]
    return level[batch, rows, cols]


def normalize_descriptors(patches: torch.Tensor) -> torch.Tensor:
    """Per-channel mean and population std over the whole descriptor set,
    then flattened to [num_desc, 7*7*C]."""
    dims = (0, 1, 2, 3)
    mean = patches.mean(dim=dims, keepdim=True)
    std = patches.std(dim=dims, keepdim=True, unbiased=False) + 1e-8
    return ((patches - mean) / std).reshape(-1, PATCH_SIZE * PATCH_SIZE * patches.shape[-1])


def _unit(dirs: torch.Tensor) -> torch.Tensor:
    return dirs / (torch.linalg.vector_norm(dirs, dim=0, keepdim=True) + 1e-12)


def _projected_sorted(desc: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    return torch.sort(desc @ _unit(dirs.to(desc.device)), dim=0).values


def sliced_distance(a: torch.Tensor, b: torch.Tensor, draws: SWDDraws, tag,
                    proj_dim: int, repeats: int) -> torch.Tensor:
    """Mean over ``repeats`` draws of mean |sort(a d) - sort(b d)|."""
    dim = a.shape[-1]
    total = a.new_zeros(())
    for rep in range(repeats):
        dirs = draws.directions(tag + (rep,), dim, proj_dim)
        total = total + torch.mean(torch.abs(_projected_sorted(a, dirs)
                                             - _projected_sorted(b, dirs)))
    return total / repeats


def sliced_wasserstein_distance(
    real: torch.Tensor,
    fake: torch.Tensor,
    patches_per_image: int = 128,
    random_sampling_count: int = 4,
    random_projection_dim: int = 128,
    min_res: int = 16,
    seed: int = 0,
    draws: Optional[SWDDraws] = None,
) -> torch.Tensor:
    """[num_levels, 2]: (real-vs-real-split, real-vs-fake) per level, on
    ``real``'s device. Multiply by 1e3 for PGGAN-paper scale. Needs input
    res >= 16 and an even real batch (split in half for the baseline)."""
    draws = draws or SWDDraws(seed)
    fake = fake.to(real.device)
    out = []
    for i, (rl, fl) in enumerate(zip(laplacian_pyramid(real, min_res),
                                     laplacian_pyramid(fake, min_res))):
        b, h, w, _ = rl.shape
        r_desc = normalize_descriptors(extract_patches(
            rl, *draws.positions(("patch", i, "real"), b, h, w, patches_per_image)))
        f_desc = normalize_descriptors(extract_patches(
            fl, *draws.positions(("patch", i, "fake"), fl.shape[0], h, w, patches_per_image)))
        half = r_desc.shape[0] // 2
        d_real = sliced_distance(r_desc[:half], r_desc[half: 2 * half], draws, ("dirs", i, "rr"),
                                 random_projection_dim, random_sampling_count)
        d_fake = sliced_distance(r_desc, f_desc, draws, ("dirs", i, "rf"),
                                 random_projection_dim, random_sampling_count)
        out.append(torch.stack([d_real, d_fake]))
    return torch.stack(out)


def sliced_wasserstein_distance_chunked(
    real: np.ndarray,
    fake: np.ndarray,
    patches_per_image: int = 128,
    random_sampling_count: int = 4,
    min_res: int = 16,
    chunk: int = 256,
    seed: int = 0,
    draws: Optional[SWDDraws] = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """The contract of ``sliced_wasserstein_distance`` ([num_levels, 2]) for
    sets too large to hold on the device at once: numpy in, numpy out.
    Images go to ``device`` ``chunk`` at a time; the raw descriptors
    gather in host memory as float32, where numpy normalises each level's
    whole set; each level's two sets then go to the device once for all
    the projection draws (128 directions each)."""
    assert real.shape == fake.shape, (real.shape, fake.shape)
    draws = draws or SWDDraws(seed)
    device = torch.device(device)
    n = real.shape[0]
    per_set_levels: dict = {0: [], 1: []}
    for set_i, images in enumerate((real, fake)):
        for lo in range(0, n, chunk):
            part = torch.as_tensor(np.asarray(images[lo: lo + chunk], np.float32)).to(device)
            for li, lvl in enumerate(laplacian_pyramid(part, min_res)):
                b, h, w, _ = lvl.shape
                pos = draws.positions(("chunk_patch", set_i, lo, li), b, h, w, patches_per_image)
                if len(per_set_levels[set_i]) <= li:
                    per_set_levels[set_i].append([])
                per_set_levels[set_i][li].append(extract_patches(lvl, *pos).cpu().numpy())

    out = []
    for li, (r_parts, f_parts) in enumerate(zip(per_set_levels[0], per_set_levels[1])):
        descs = []
        for parts in (r_parts, f_parts):
            p = np.concatenate(parts)  # [N, P, 7, 7, C]
            mean = p.mean(axis=(0, 1, 2, 3), keepdims=True)
            std = p.std(axis=(0, 1, 2, 3), keepdims=True) + 1e-8
            descs.append(((p - mean) / std).reshape(-1, PATCH_SIZE * PATCH_SIZE * p.shape[-1]))
        r_dev, f_dev = (torch.as_tensor(d).to(device) for d in descs)
        half = len(r_dev) // 2
        dim = r_dev.shape[-1]
        d_real = d_fake = 0.0
        for rep in range(random_sampling_count):
            k_rr = draws.directions(("chunk_dirs", li, "rr", rep), dim, 128)
            k_rf = draws.directions(("chunk_dirs", li, "rf", rep), dim, 128)
            ra = _projected_sorted(r_dev[:half], k_rr)
            rb = _projected_sorted(r_dev[half: 2 * half], k_rr)
            d_real += float(torch.mean(torch.abs(ra - rb)))
            pa = _projected_sorted(r_dev, k_rf)
            pb = _projected_sorted(f_dev, k_rf)
            d_fake += float(torch.mean(torch.abs(pa - pb)))
        del r_dev, f_dev
        out.append([d_real / random_sampling_count, d_fake / random_sampling_count])
    return np.asarray(out, np.float32)
