"""TwinGAN configuration and translation, in PyTorch.

Counterpart of ``twingan_tpu/train/twingan_trainer.py``: ``TwinGANConfig``
field for field (same defaults and validation), the encoder + generator
pair a translation needs (``TwinGANTranslator``, whose ``state_dict`` keys
are the JAX ``params`` keys ``encoder_content`` / ``generator`` followed by
the Flax paths), and ``translate`` with the contract of
``TwinGANTrainer.translate``: the encoder runs in the source domain and the
generator in the target domain with eval statistics, the generator takes
the UNet skips when ``use_unet``, and on a growing stage the fade-in alpha
follows the step. The training step belongs to the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from twingan_tpu_torch.models.config import PGGANConfig
from twingan_tpu_torch.models.pggan import Encoder, Generator
from twingan_tpu_torch.train.losses import GanLossConfig
from twingan_tpu_torch.train.optimizers import OptimizerConfig

ENC = "encoder_content"
GEN = "generator"

DOMAIN_S = 0
DOMAIN_T = 1


@dataclasses.dataclass(frozen=True)
class TwinGANConfig:
    model: PGGANConfig = dataclasses.field(
        default_factory=lambda: PGGANConfig(num_domains=2)
    )
    loss: GanLossConfig = dataclasses.field(default_factory=GanLossConfig)
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    batch_size: int = 8
    n_critic: int = 2
    use_ttur: bool = False
    discriminator_learning_rate: float = 0.0004
    use_gdrop: bool = False
    gdrop_coef: float = 0.2
    gdrop_lim: float = 0.5
    gdrop_exp: float = 2.0
    grow_start_step: int = 0
    max_steps: int = 300000
    l_cyc_weight: float = 1.0
    do_l_cyc_gan: bool = True
    l_content_weight: float = 0.1
    use_style_embedding: bool = False
    style_embed_size: int = 16
    use_unet: bool = False
    do_encoder_distillation: bool = False
    distillation_weight: float = 1.0
    distillation_start_hw: int = 16
    source_embed_dim: int = 0
    target_embed_dim: int = 0
    moving_average_decay: float = 0.0
    remat: bool = False
    fuse_passes: Optional[bool] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def batch_coupled_norm(self) -> bool:
        return self.model.norm_type.startswith(("batch_norm", "batch_renorm"))

    def __post_init__(self):
        if self.model.num_domains != 2:
            raise ValueError("TwinGAN requires model.num_domains == 2")
        if self.use_style_embedding and self.model.style_dim != self.style_embed_size:
            raise ValueError(
                "model.style_dim must equal style_embed_size when "
                "use_style_embedding is on"
            )
        if self.fuse_passes and self.batch_coupled_norm:
            raise ValueError(
                "fuse_passes=True with a batch-coupled norm "
                f"({self.model.norm_type}) would mix the per-pass batch "
                "moments; use per-sample norms or fuse_passes=False"
            )


def fade_alpha(cfg: TwinGANConfig, step: int) -> float:
    """The fade-in alpha at ``step``: 0 on a stable stage, else the linear
    ramp over [grow_start_step, max_steps] (JAX BaseGanTrainer._alpha)."""
    if not cfg.model.is_growing:
        return 0.0
    denom = max(cfg.max_steps - cfg.grow_start_step, 1)
    return float(step - cfg.grow_start_step) / denom


class TwinGANTranslator(nn.Module):
    """The content encoder and the generator of a TwinGAN stage."""

    def __init__(self, cfg: TwinGANConfig):
        super().__init__()
        if cfg.use_style_embedding:
            raise NotImplementedError("use_style_embedding is not ported to twingan_tpu_torch yet")
        self.cfg = cfg
        self.add_module(ENC, Encoder(cfg.model))
        self.add_module(GEN, Generator(cfg.model, unet=cfg.use_unet))


def translate(cfg: TwinGANConfig, enc: Encoder, gen: Generator, images: torch.Tensor,
              direction: str = "s2t", step: int = 0) -> torch.Tensor:
    """Source-domain NHWC images in [0,1] -> target-domain images (or the
    reverse for ``direction='t2s'``), as ``TwinGANTrainer.translate``."""
    if direction not in ("s2t", "t2s"):
        raise ValueError(f"unknown direction {direction!r}")
    src_domain = DOMAIN_S if direction == "s2t" else DOMAIN_T
    out_domain = DOMAIN_T if direction == "s2t" else DOMAIN_S
    alpha = fade_alpha(cfg, step)
    with torch.inference_mode():
        code, skips = enc(images, alpha=alpha, domain=src_domain)
        return gen(code, alpha=alpha, domain=out_domain,
                   unet_skips=skips if cfg.use_unet else None)
