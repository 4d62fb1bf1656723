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
- ``inception_pool_features_fn``: random-init InceptionV3 features (the
  port's own draws, or given weights) and ``classifier_features_fn``: a
  trained classifier's, the feature functions of FID and the inception
  score;
- ``streaming_loss_eval``: the mean of every loss over eval batches.

The metrics run on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from twingan_tpu_torch.ops.basic import resize_bilinear
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


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """``scipy.linalg.sqrtm`` without its printed accuracy warning: SciPy
    up to 1.17 takes ``disp=False`` and returns (root, error estimate);
    1.18 drops ``disp`` and returns the root alone."""
    from scipy import linalg

    try:
        return linalg.sqrtm(m, disp=False)[0]
    except TypeError:
        return linalg.sqrtm(m)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians:
    |mu1-mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        # Regularize singular covariances (small sample counts).
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
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


def _pooled(eps: dict, endpoint: str, batch: int) -> torch.Tensor:
    feat = eps[endpoint]
    if feat.dim() == 4:
        feat = torch.mean(feat, dim=(1, 2))
    return feat.reshape(batch, -1)


def inception_pool_features_fn(image_hw: int = 64, seed: int = 0, endpoint: str = "Mixed_5b",
                               weights: Optional[Dict[str, torch.Tensor]] = None,
                               device: Optional[torch.device | str] = None
                               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Images in [0, 1] -> InceptionV3 features at ``endpoint``, spatially
    mean-pooled ([B, 256] at ``Mixed_5b``).

    No pretrained weights are in the repo, so the network is randomly
    initialized, as the JAX function's is: FID over these features is a
    relative metric, not comparable to published numbers. With random init
    the deep end points collapse, so the default is the first mixed block.
    The port draws its weights from its own generator seeded by ``seed``,
    not from JAX's PRNG: its numbers differ from the JAX package's at the
    same seed. ``weights`` (an InceptionV3 ``state_dict``, such as the JAX
    package's initialization bridged by ``bridge.classifier_state_dict_
    from_flax``) replaces the draws. Images are resized (bilinear,
    antialiased where it shrinks) to max(image_hw, 75) px, the least size
    the stride stack takes, and scaled to [-1, 1]; the network stops at
    ``endpoint`` when it is one of the first mixed blocks."""
    from twingan_tpu_torch.models.classifiers import reset_parameters
    from twingan_tpu_torch.models.inception import InceptionV3

    device = resolve_device(device)
    init_hw = max(image_hw, 75)
    net = InceptionV3(num_classes=1, image_hw=init_hw)
    if weights is None:
        reset_parameters(net, torch.Generator().manual_seed(int(seed)))
    else:
        net.load_state_dict(weights, strict=True)
    net.to(device).eval()

    @torch.no_grad()
    def features(images: torch.Tensor) -> torch.Tensor:
        images = torch.as_tensor(images).to(device, torch.float32)
        if images.shape[1] != init_hw:
            images = resize_bilinear(images, init_hw, init_hw)
        _, eps = net(images * 2.0 - 1.0, stop_at=endpoint)
        return _pooled(eps, endpoint, images.shape[0])

    return features


def classifier_fn(classifier_dir: str, device: Optional[torch.device | str] = None
                  ) -> Callable[[torch.Tensor], tuple]:
    """Images in [0, 1] -> (logits, end_points) of a trained classifier's
    train dir (the port's ``runner/classifier_runner.py`` writes one; a JAX
    one converts with ``tools/orbax_to_torch_stage.py``), in eval mode.
    Images are resized to the classifier's ``image_hw`` first: fixed heads
    need it, and other sizes score off its training distribution."""
    from twingan_tpu_torch.runner.classifier_runner import load_trained_classifier

    trainer, state = load_trained_classifier(classifier_dir, device=device)
    net, cls_hw, device = state.net.eval(), trainer.cfg.image_hw, trainer.device

    @torch.no_grad()
    def forward(images: torch.Tensor) -> tuple:
        images = torch.as_tensor(images).to(device, torch.float32)
        if images.shape[1] != cls_hw:
            images = resize_bilinear(images, cls_hw, cls_hw)
        return net(images)

    return forward


def classifier_features_fn(classifier_dir: str, layer: str = "PreLogits",
                           device: Optional[torch.device | str] = None
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Images in [0, 1] -> the features at ``layer`` (mean-pooled if
    spatial) of ``classifier_fn``'s classifier."""
    forward = classifier_fn(classifier_dir, device)

    def features(images: torch.Tensor) -> torch.Tensor:
        _, eps = forward(images)
        return _pooled(eps, layer, len(images))

    return features


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
