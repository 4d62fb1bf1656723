"""Static model configuration: the port's own copy of ``PGGANConfig``.

Field for field the same dataclass as ``twingan_tpu/models/config.py``
(same names, defaults and validation), so a ``config.json`` written by the
JAX runner loads here unchanged. It is a copy, not an import: the JAX
module's package pulls in flax.

Every option of the JAX config is ported, at every channel width: every
norm type, spectral norm (in and outside the discriminator), conditional
norms (``style_dim``) and ``fused_scale``; ``fused_scale`` runs the plain
nearest-up2 and conv, which compute the same function as the JAX
package's fused forms.
``quantized_inference`` (W8A8 int8 serving) is ported for the encoder,
the generator and the heads; ``require_inference_only`` refuses it where
a network trains or discriminates.
"""

from __future__ import annotations

import dataclasses
import math

NORM_TYPES = ("none", "batch_norm", "instance_norm", "batch_renorm", "layer_norm")


@dataclasses.dataclass(frozen=True)
class PGGANConfig:
    """Everything static about a PGGAN generator/discriminator/encoder stack
    (one growth stage). See the JAX class for each field's meaning."""

    resolution: int = 4
    is_growing: bool = False
    image_channels: int = 3

    max_channels: int = 256
    max_channels_dis: int | None = None
    min_channels: int = 0

    norm_type: str = "batch_norm"
    do_pixel_norm: bool = False
    sync_batch_norm_axis: str | None = None
    bn_num_groups: int = 0

    equalized_lr: bool = False
    spectral_norm: bool = False
    spectral_norm_in_non_discriminator: bool = False
    init_stddev: float = 0.02

    fused_scale: bool = False
    fused_scale_impl: str = "dilated"

    use_res_block: bool = False
    use_larger_filter_at_rgb_layer: bool = False
    do_self_attention: bool = False
    self_attention_hw: int = 64
    attention_context_parallel: bool = False
    unet_max_concat_hw: int | None = None

    num_domains: int = 1
    style_dim: int = 0
    dtype: str = "float32"
    quantized_inference: str = ""

    def __post_init__(self):
        if self.norm_type not in NORM_TYPES:
            raise ValueError(f"unknown norm_type {self.norm_type!r}")
        if self.resolution < 4 or self.resolution & (self.resolution - 1):
            raise ValueError("resolution must be a power of two >= 4")
        if self.is_growing and self.resolution == 4:
            raise ValueError("the 4x4 stage cannot be growing")
        if self.fused_scale_impl not in ("dilated", "parity"):
            raise ValueError(
                f"unknown fused_scale_impl {self.fused_scale_impl!r}"
            )
        if self.quantized_inference not in ("", "calib", "int8"):
            raise ValueError(
                f"unknown quantized_inference {self.quantized_inference!r}"
            )

    @property
    def max_stage(self) -> int:
        """hw=4 -> 0, hw=8 -> 1, ..."""
        return int(math.log2(self.resolution)) - 2

    @property
    def dis_max_channels(self) -> int:
        return self.max_channels_dis or self.max_channels

    def channels(self, stage: int, discriminator: bool = False) -> int:
        limit = self.dis_max_channels if discriminator else self.max_channels
        ch = int(min(1024 // (2**stage), limit))
        return max(ch, self.min_channels) if self.min_channels else ch

    @property
    def noise_dim(self) -> int:
        return self.channels(1)

    def replace(self, **kw) -> "PGGANConfig":
        return dataclasses.replace(self, **kw)


def require_inference_only(cfg: PGGANConfig, where: str) -> None:
    """Raise ``ValueError`` where ``quantized_inference`` is set: it serves
    a trained encoder and generator, and has no training or discriminator
    path (as in the JAX package, whose config calls it inference-only)."""
    if cfg.quantized_inference:
        raise ValueError(
            f"quantized_inference={cfg.quantized_inference!r} is inference-only: {where} "
            "takes the fp model (calibrate a trained stage with "
            "twingan_tpu_torch.infer.quantize.calibrate to serve it in int8)")
