"""GAN loss library: gan | dragan | wgan | wgan_gp | hinge.

Counterpart of ``twingan_tpu/train/losses.py`` with the same config fields,
defaults and validation (``GanLossConfig``), and the same functions:

- 'gan'/'dragan': sigmoid cross-entropy (G: fool loss vs ones; D: fake vs 0
  plus real vs 1); dragan adds a gradient penalty on perturbed real images.
- 'wgan'/'wgan_gp': G: -mean(fake); D: mean(fake) - mean(real), optional
  drift penalty wd*mean(real^2); wgan_gp adds the interpolate penalty.
- 'hinge': G: -mean(fake); D: mean(relu(1+fake)) + mean(relu(1-real)).

Predictions are cast to fp32 before any loss math. The gradient penalty
differentiates the discriminator twice (``torch.autograd.grad`` with
``create_graph=True``), so the caller's ``dis_fn`` must run a twice
differentiable discriminator (its attention on the plain route).

Random numbers: JAX draws the penalty's interpolation alpha and the DRAGAN
perturbation from a PRNG key the port cannot reproduce, so
``gradient_penalty`` takes them as tensors, or draws them from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from twingan_tpu_torch import parallel
from twingan_tpu_torch.parallel.multihost import all_reduce_mean

ARCHITECTURES = ("gan", "dragan", "wgan", "wgan_gp", "hinge")


@dataclasses.dataclass(frozen=True)
class GanLossConfig:
    architecture: str = "dragan"
    gan_weight: float = 1.0
    gradient_penalty_lambda: float = 10.0
    wgan_drift_loss_weight: float = 0.0

    def __post_init__(self):
        if self.architecture not in ARCHITECTURES:
            raise ValueError(f"unsupported loss architecture {self.architecture!r}")


def _sigmoid_ce(logits: torch.Tensor, label: float) -> torch.Tensor:
    """Mean sigmoid cross entropy vs a constant label, in the stable form
    max(z,0) - z*y + log(1+exp(-|z|))."""
    z = logits.float()
    return torch.mean(torch.clamp(z, min=0) - z * label + torch.log1p(torch.exp(-torch.abs(z))))


def generator_gan_loss(cfg: GanLossConfig, fake_pred: torch.Tensor) -> torch.Tensor:
    """The weighted 'fool the discriminator' term."""
    fake_pred = fake_pred.float()
    if cfg.architecture in ("wgan", "wgan_gp", "hinge"):
        loss = -torch.mean(fake_pred)
    else:
        loss = _sigmoid_ce(fake_pred, 1.0)
    return cfg.gan_weight * loss


def discriminator_gan_loss(cfg: GanLossConfig, fake_pred: torch.Tensor,
                           real_pred: torch.Tensor) -> dict[str, torch.Tensor]:
    """The named, weighted real/fake discriminator terms (no penalty)."""
    fake_pred, real_pred = fake_pred.float(), real_pred.float()
    losses: dict[str, torch.Tensor] = {}
    if cfg.architecture in ("wgan", "wgan_gp"):
        losses["discriminator_loss"] = cfg.gan_weight * (torch.mean(fake_pred) - torch.mean(real_pred))
        if cfg.wgan_drift_loss_weight:
            losses["discriminator_drift_loss"] = (
                cfg.wgan_drift_loss_weight * torch.mean(torch.square(real_pred)))
    elif cfg.architecture == "hinge":
        losses["discriminator_loss"] = cfg.gan_weight * (
            torch.mean(torch.relu(1 + fake_pred)) + torch.mean(torch.relu(1 - real_pred)))
    else:
        losses["discriminator_fake_loss"] = cfg.gan_weight * _sigmoid_ce(fake_pred, 0.0)
        losses["discriminator_real_loss"] = cfg.gan_weight * _sigmoid_ce(real_pred, 1.0)
    return losses


def perturbed_batch(x: torch.Tensor, noise: torch.Tensor, group=None) -> torch.Tensor:
    """DRAGAN perturbation x + 0.5 * std(x) * noise, the std the population
    one over the whole minibatch and ``noise`` U(-1, 1) of x's shape (the
    JAX package's deliberate use of the std, where the TF original took the
    variance). Under a process group ``group`` the mean and then the
    squared deviations' mean are averaged over the processes' equal shares
    of the minibatch."""
    mean = all_reduce_mean(torch.mean(x), group)
    std = torch.sqrt(all_reduce_mean(torch.mean(torch.square(x - mean)), group))
    return x + 0.5 * std * noise


def gradient_penalty(cfg: GanLossConfig, dis_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: Optional[torch.Tensor], *,
                     alpha: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """WGAN-GP / DRAGAN gradient penalty, weighted by lambda; 0 for the other
    architectures.

    wgan_gp interpolates between ``real`` and ``fake``; dragan between
    ``real`` and its perturbation. ``alpha`` ([B,1,1,1], U(0,1)) and, for
    dragan, ``noise`` (U(-1,1), real's shape) are drawn from ``generator``
    when not given, at the global batch under a process group
    (``parallel.draw_rows``). The penalty is lambda * mean((|grad|_2 - 1)^2)
    with |grad|_2 = sqrt(sum grad^2 + 1e-12) per example."""
    if cfg.architecture not in ("wgan_gp", "dragan"):
        return torch.zeros((), device=real.device)
    real = real.float()
    if alpha is None:
        alpha = parallel.draw_rows(torch.rand, (real.shape[0],) + (1,) * (real.dim() - 1),
                                   generator=generator, device=real.device)
    if cfg.architecture == "wgan_gp":
        if fake is None:
            raise ValueError("wgan_gp needs the generated batch")
        endpoint = fake.float()
    else:
        if noise is None:
            noise = parallel.draw_rows(torch.rand, real.shape, generator=generator,
                                       device=real.device) * 2 - 1
        endpoint = perturbed_batch(real, noise.to(real.device), parallel.current_group())
    interpolates = (real + alpha.to(real.device) * (endpoint - real)).detach().requires_grad_(True)
    pred_sum = torch.sum(dis_fn(interpolates).float())
    (grads,) = torch.autograd.grad(pred_sum, interpolates, create_graph=True)
    slopes = torch.sqrt(torch.sum(torch.square(grads.float()), dim=tuple(range(1, grads.dim())))
                        + 1e-12)
    return cfg.gradient_penalty_lambda * torch.mean(torch.square(slopes - 1.0))


def l1_loss(a: torch.Tensor, b: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Mean absolute difference (tf.losses.absolute_difference)."""
    return weight * torch.mean(torch.abs(a.float() - b.float()))


def cosine_distance_loss(expected: torch.Tensor, embedding: torch.Tensor,
                         weight: float = 1.0) -> torch.Tensor:
    """Mean cosine distance of l2-normalized vectors over the batch."""
    e, m = expected.float(), embedding.float()
    e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-12)
    m = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-12)
    return weight * torch.mean(1.0 - torch.sum(e * m, dim=-1))
