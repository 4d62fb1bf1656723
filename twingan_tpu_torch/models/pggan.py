"""PGGAN encoder and generator for translation, as ``nn.Module``s.

Counterpart of ``Encoder``, ``Generator`` and ``EncoderSkips`` in
``twingan_tpu/models/pggan.py``: the same stages, fade-in blend, channel
schedule, UNet skip lookup, self-attention placement and layer names
(``block_64_conv0``, ``to_rgb_256``, ``self_attention_64``, ...), registered
as direct submodules so ``state_dict`` keys read like the Flax paths.

PyTorch needs every layer's input width when the module is built, where
Flax infers it at the first call, so the generator is told whether UNet
skips will come (``unet``) and takes the encoder's [B,4,4,C] code (the
noise-input variant belongs to the generation slice).

Both modules take and return NHWC tensors and compute on NCHW views. They
are inference modules, built in eval mode: norms use moving statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from twingan_tpu_torch.models.config import PGGANConfig, require_ported
from twingan_tpu_torch.models.layers import ConvBlock, ResBlockAdd, SelfAttention, torch_dtype
from twingan_tpu_torch.ops import basic


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@dataclasses.dataclass
class EncoderSkips:
    """UNet skip features keyed by resolution (NHWC).

    blocks[hw]: the encoder block output at hw (before its pool).
    interp[hw]: the fade-in blended feature at hw (growing stages only); the
    generator prefers it when its channel count matches."""

    blocks: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    interp: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)

    def lookup(self, hw: int, expected_ch: int) -> torch.Tensor:
        feat = self.interp.get(hw)
        if feat is not None and feat.shape[-1] == expected_ch:
            return feat
        feat = self.blocks.get(hw)
        if feat is None:
            raise ValueError(f"no UNet skip for resolution {hw}")
        return feat


class Encoder(nn.Module):
    """Discriminator-shaped encoder with generator norms: [B,res,res,3] ->
    the [B,4,4,C] code plus UNet skip features."""

    def __init__(self, cfg: PGGANConfig):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        max_stage = cfg.max_stage
        res = cfg.resolution
        self._from_rgb(f"from_rgb_{res}", cfg.channels(max_stage))
        if cfg.is_growing:
            self._from_rgb(f"from_rgb_{res // 2}", cfg.channels(max_stage - 1))
        for stage in range(max_stage, 0, -1):
            hw = res >> (max_stage - stage)
            in_ch, ch_out = cfg.channels(stage), cfg.channels(stage - 1)
            if cfg.do_self_attention and hw == cfg.self_attention_hw:
                self.add_module(f"self_attention_{hw}", SelfAttention(cfg, in_ch))
            self.add_module(f"block_{hw}_conv0", ConvBlock(cfg, in_ch, in_ch))
            self.add_module(f"block_{hw}_conv1", ConvBlock(cfg, in_ch, ch_out))
            self.add_module(f"block_{hw}_res", ResBlockAdd(cfg, in_ch, ch_out))
        self.eval()

    def _from_rgb(self, name: str, features: int) -> None:
        c = self.cfg.image_channels
        self.add_module(f"{name}_conv", ConvBlock(self.cfg, c, features, kernel_size=1))
        self.add_module(f"{name}_res", ResBlockAdd(self.cfg, c, features))

    def _apply_from_rgb(self, name: str, t: torch.Tensor, domain: int) -> torch.Tensor:
        y = getattr(self, f"{name}_conv")(t, domain)
        if self.cfg.do_pixel_norm:
            y = basic.pixel_norm(y, dim=1)
        return getattr(self, f"{name}_res")(t, y, domain)

    def forward(self, x: torch.Tensor, *, alpha: float = 0.0,
                domain: int = 0) -> tuple[torch.Tensor, EncoderSkips]:
        cfg = self.cfg
        skips = EncoderSkips()
        max_stage = cfg.max_stage
        src_hw = x.shape[1]
        if src_hw != cfg.resolution:
            raise ValueError(f"encoder expects {cfg.resolution} px input, got {src_hw}")
        x = _nchw(x).to(torch_dtype(cfg.dtype))

        shrunk = None
        if cfg.is_growing:
            shrunk = basic.avg_pool_2x(x, nchw=True)
            shrunk = self._apply_from_rgb(f"from_rgb_{src_hw // 2}", shrunk, domain)
        net = self._apply_from_rgb(f"from_rgb_{src_hw}", x, domain)

        for stage in range(max_stage, 0, -1):
            hw = src_hw >> (max_stage - stage)
            if cfg.do_self_attention and hw == cfg.self_attention_hw:
                net = getattr(self, f"self_attention_{hw}")(net, domain)
            y = getattr(self, f"block_{hw}_conv0")(net, domain)
            if cfg.do_pixel_norm:
                y = basic.pixel_norm(y, dim=1)
            y = getattr(self, f"block_{hw}_conv1")(y, domain)
            if cfg.do_pixel_norm:
                y = basic.pixel_norm(y, dim=1)
            net = getattr(self, f"block_{hw}_res")(net, y, domain)
            skips.blocks[hw] = _nhwc(net)
            net = basic.avg_pool_2x(net, nchw=True)
            if stage == max_stage and cfg.is_growing:
                net = basic.blend(net, shrunk, alpha)
                skips.interp[hw // 2] = _nhwc(net)
        return _nhwc(net), skips


class Generator(nn.Module):
    """PGGAN generator for translation: the [B,4,4,channels(0)] code (and
    UNet skips when ``unet``) -> [B,res,res,image_channels]."""

    def __init__(self, cfg: PGGANConfig, unet: bool = False):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.unet = unet
        ch0 = cfg.channels(0)
        self.add_module("block_4_conv0", ConvBlock(cfg, ch0, ch0))
        self.add_module("block_4_conv1", ConvBlock(cfg, ch0, ch0))
        self._maybe_attention(4, ch0)
        for stage in range(1, cfg.max_stage + 1):
            hw = 2 ** (stage + 2)
            ch, prev = cfg.channels(stage), cfg.channels(stage - 1)
            if stage == cfg.max_stage and cfg.is_growing:
                self._to_rgb(hw // 2, prev)
            in_ch = prev + (prev if self._has_skip(hw) else 0)
            self.add_module(f"block_{hw}_conv0", ConvBlock(cfg, in_ch, ch))
            self.add_module(f"block_{hw}_conv1", ConvBlock(cfg, ch, ch))
            self.add_module(f"block_{hw}_res", ResBlockAdd(cfg, in_ch, ch))
            self._maybe_attention(hw, ch)
        self._to_rgb(cfg.resolution, cfg.channels(cfg.max_stage))
        self.eval()

    def _has_skip(self, hw: int) -> bool:
        limit = self.cfg.unet_max_concat_hw
        return self.unet and not (limit and hw > limit)

    def _maybe_attention(self, hw: int, channels: int) -> None:
        if self.cfg.do_self_attention and hw == self.cfg.self_attention_hw:
            self.add_module(f"self_attention_{hw}", SelfAttention(self.cfg, channels))

    def _rgb_kernel(self, hw: int) -> int:
        return min(7, hw // 2) if self.cfg.use_larger_filter_at_rgb_layer else 1

    def _to_rgb(self, hw: int, in_ch: int) -> None:
        self.add_module(f"to_rgb_{hw}", ConvBlock(
            self.cfg, in_ch, self.cfg.image_channels,
            kernel_size=self._rgb_kernel(hw), activation=None))

    def forward(self, source: torch.Tensor, *, alpha: float = 0.0, domain: int = 0,
                unet_skips: Optional[EncoderSkips] = None) -> torch.Tensor:
        cfg = self.cfg
        if source.dim() != 4 or source.shape[1:3] != (4, 4):
            raise NotImplementedError(
                "the port's generator takes the [B,4,4,C] encoder code; the "
                "noise input is not ported yet")
        if self.unet != (unet_skips is not None):
            raise ValueError("generator built with unet=%s got unet_skips=%s"
                             % (self.unet, unet_skips is not None))
        net = _nchw(source).to(torch_dtype(cfg.dtype))
        prev_rgb = None

        net = self.block_4_conv0(net, domain)
        if cfg.do_pixel_norm:
            net = basic.pixel_norm(net, dim=1)
        net = self.block_4_conv1(net, domain)
        if cfg.do_pixel_norm:
            net = basic.pixel_norm(net, dim=1)
        if cfg.do_self_attention and cfg.self_attention_hw == 4:
            net = self.self_attention_4(net, domain)

        for stage in range(1, cfg.max_stage + 1):
            hw = 2 ** (stage + 2)
            if stage == cfg.max_stage and cfg.is_growing:
                prev_rgb = getattr(self, f"to_rgb_{hw // 2}")(net, domain)
                prev_rgb = basic.upsample_nearest_2x(prev_rgb, nchw=True)
            inp = basic.upsample_nearest_2x(net, nchw=True)
            if self._has_skip(hw):
                skip = unet_skips.lookup(hw, cfg.channels(stage - 1))
                inp = torch.cat([inp, _nchw(skip).to(inp.dtype)], dim=1)
            y = getattr(self, f"block_{hw}_conv0")(inp, domain)
            if cfg.do_pixel_norm:
                y = basic.pixel_norm(y, dim=1)
            y = getattr(self, f"block_{hw}_conv1")(y, domain)
            if cfg.do_pixel_norm:
                y = basic.pixel_norm(y, dim=1)
            net = getattr(self, f"block_{hw}_res")(inp, y, domain)
            if cfg.do_self_attention and hw == cfg.self_attention_hw:
                net = getattr(self, f"self_attention_{hw}")(net, domain)

        rgb = getattr(self, f"to_rgb_{cfg.resolution}")(net, domain)
        out = basic.blend(rgb, prev_rgb, alpha) if cfg.is_growing else rgb
        return _nhwc(out)
