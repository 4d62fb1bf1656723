"""Evaluation metrics: the SWD protocol, the MS-SSIM gate, FID and the
inception score, streaming loss means.

Counterpart of ``twingan_tpu/evals/metrics.py``:
- ``swd_eval``: accumulate ``num_images`` real/fake pairs, the sliced
  Wasserstein distance per Laplacian level down to 16 px, scores x1e3 in a
  {resolution: (real, fake)} table and its text file ('res\\treal\\tfake'
  rows and an Average row); None below 16 px. Sets over 512 MiB take the
  chunked path. The JAX function takes a PRNG key; this one a ``seed``
  (and optionally ``draws``, see ``ops/swd.py``).
- ``msssim_eval`` (even/odd pairs of each batch) and ``pairwise_msssim``;
- ``inception_score``, ``frechet_distance``, ``activation_statistics`` and
  ``fid`` over a given logits or features function (called on torch
  tensors on ``device``);
- ``streaming_loss_eval``: the mean of every loss over eval batches.

The feature extractors of the classifier zoo (``inception_pool_features_fn``,
``classifier_features_fn``) wait for the classifiers' port (queue item
A14) and raise. The metrics run on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from twingan_tpu_torch.ops.msssim import msssim
from twingan_tpu_torch.ops.swd import (
    SWDDraws,
    sliced_wasserstein_distance,
    sliced_wasserstein_distance_chunked,
)
from twingan_tpu_torch.train.base import resolve_device

# Image sets larger than this take the chunked SWD path.
SWD_CHUNKED_BYTES = 512 * 1024 * 1024


def swd_eval(
    seed: int,
    real_batches: Iterable[np.ndarray],
    fake_batches: Iterable[np.ndarray],
    num_images: int = 8192,
    save_path: Optional[str] = None,
    step: int = 0,
    device: Optional[torch.device | str] = None,
    draws: Optional[SWDDraws] = None,
) -> Optional[dict]:
    """The reference SWD protocol; returns {resolution: (real, fake)} x1e3."""
    reals, fakes, n_r, n_f = [], [], 0, 0
    for r, f in zip(real_batches, fake_batches):
        reals.append(np.asarray(r, np.float32))
        fakes.append(np.asarray(f, np.float32))
        n_r += len(reals[-1])
        n_f += len(fakes[-1])
        # Stop only once both sets are full: unequal batch sizes would
        # otherwise leave one set short.
        if n_r >= num_images and n_f >= num_images:
            break
    if not reals or not fakes:
        return None
    n = min(n_r, n_f, num_images)
    real = np.concatenate(reals)[:n]
    fake = np.concatenate(fakes)[:n]
    res = real.shape[1]
    if res < 16:
        return None  # 'Not doing swd on small images.'
    device = resolve_device(device)
    draws = draws or SWDDraws(seed)
    if real.nbytes > SWD_CHUNKED_BYTES:
        scores = sliced_wasserstein_distance_chunked(real, fake, draws=draws,
                                                     device=device) * 1e3
    else:
        scores = sliced_wasserstein_distance(
            torch.from_numpy(real).to(device), torch.from_numpy(fake).to(device),
            draws=draws).cpu().numpy() * 1e3
    resolutions = []
    r = res
    while r >= 16:
        resolutions.append(r)
        r //= 2
    table = {hw: (float(scores[i][0]), float(scores[i][1])) for i, hw in enumerate(resolutions)}
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        with open(save_path, "w") as f:
            f.write(f"swd sliced wasserstein score evaluated on {len(real)} images.\n")
            f.write("res\treal\tfake\n")
            for hw in resolutions:
                f.write(f"{hw}\t{table[hw][0]:f}\t{table[hw][1]:f}\n")
            avg = scores.mean(axis=0)
            f.write(f"Average\t{avg[0]:f}\t{avg[1]:f}\n")
    return table


def msssim_eval(batches: Iterable[np.ndarray], num_images: int = 0, max_val: float = 1.0,
                device: Optional[torch.device | str] = None) -> float:
    """Mean MS-SSIM over even/odd pairs within each batch; NaN when no pair
    was measured (0.0 would read as a perfect diversity score)."""
    device = resolve_device(device)
    total, count = 0.0, 0
    for batch in batches:
        batch = torch.as_tensor(np.asarray(batch, np.float32)).to(device)
        pairs = len(batch) // 2
        if pairs == 0:
            continue
        score = float(msssim(batch[0: 2 * pairs: 2], batch[1: 2 * pairs: 2], max_val=max_val))
        total += score * pairs
        count += pairs
        if num_images and count * 2 >= num_images:
            break
    if count == 0:
        return float("nan")
    return total / count


def pairwise_msssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0,
                    device: Optional[torch.device | str] = None) -> float:
    """Direct MS-SSIM between two aligned sets (the fidelity gate)."""
    device = resolve_device(device)
    return float(msssim(torch.as_tensor(np.asarray(a, np.float32)).to(device),
                        torch.as_tensor(np.asarray(b, np.float32)).to(device), max_val=max_val))


def _as_numpy(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def inception_score(logits_fn: Callable[[torch.Tensor], torch.Tensor],
                    batches: Iterable[np.ndarray], splits: int = 10,
                    device: Optional[torch.device | str] = None) -> tuple[float, float]:
    """exp(E KL(p(y|x) || p(y))) with the reference's split protocol."""
    device = resolve_device(device)
    preds = []
    for batch in batches:
        logits = _as_numpy(logits_fn(torch.as_tensor(np.asarray(batch)).to(device)))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        preds.append(e / e.sum(axis=-1, keepdims=True))
    preds = np.concatenate(preds)
    scores = []
    for i in range(splits):
        part = preds[i * len(preds) // splits: (i + 1) * len(preds) // splits]
        if len(part) == 0:
            continue
        kl = part * (np.log(part + 1e-12) - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians:
    |mu1-mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2))."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        # Regularize singular covariances (small sample counts).
        offset = np.eye(sigma1.shape[0]) * eps
        covmean, _ = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset), disp=False)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def activation_statistics(features_fn: Callable[[torch.Tensor], torch.Tensor],
                          batches: Iterable[np.ndarray],
                          device: Optional[torch.device | str] = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of feature activations over batches of images."""
    device = resolve_device(device)
    feats = []
    for batch in batches:
        f = _as_numpy(features_fn(torch.as_tensor(np.asarray(batch)).to(device)))
        feats.append(f.reshape(f.shape[0], -1))
    feats = np.concatenate(feats)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def fid(features_fn: Callable[[torch.Tensor], torch.Tensor],
        real_batches: Iterable[np.ndarray], fake_batches: Iterable[np.ndarray],
        device: Optional[torch.device | str] = None) -> float:
    """Fréchet distance between ``features_fn`` activations of two sets."""
    mu_r, sig_r = activation_statistics(features_fn, real_batches, device)
    mu_f, sig_f = activation_statistics(features_fn, fake_batches, device)
    return frechet_distance(mu_r, sig_r, mu_f, sig_f)


def inception_pool_features_fn(image_hw: int = 64, seed: int = 0, endpoint: str = "Mixed_5b"):
    raise NotImplementedError(
        "inception_pool_features_fn needs InceptionV3 of the classifier zoo, which is not "
        "ported to twingan_tpu_torch yet (queue item A14)")


def classifier_features_fn(classifier_dir: str, layer: str = "PreLogits"):
    raise NotImplementedError(
        "classifier_features_fn needs the trained classifiers, which are not ported to "
        "twingan_tpu_torch yet (queue item A14)")


def streaming_loss_eval(loss_fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                        batches: Iterable[Dict[str, np.ndarray]],
                        num_batches: int = 0) -> Dict[str, float]:
    """Mean of every named loss over eval batches (slim streaming_mean).
    ``loss_fn`` gets each batch's numeric items as CPU tensors. String
    items (a real dataset's filenames) are left out: the JAX function hands
    them to ``jnp.asarray``, which raises, so its loss mode fails on image
    records that carry filenames."""
    sums: Dict[str, float] = {}
    count = 0
    for batch in batches:
        losses = loss_fn({k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()
                          if np.asarray(v).dtype.kind not in "SUO"})
        for k, v in losses.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
        if num_batches and count >= num_batches:
            break
    return {k: v / max(count, 1) for k, v in sums.items()}
