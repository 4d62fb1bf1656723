"""PGGAN encoder, generator and discriminator, as ``nn.Module``s.

Counterpart of ``Encoder``, ``Generator``, ``Discriminator`` and
``EncoderSkips`` in ``twingan_tpu/models/pggan.py``: the same stages,
fade-in blend, channel schedule, UNet skip lookup, self-attention placement
and layer names (``block_64_conv0``, ``to_rgb_256``, ``self_attention_64``,
``prediction``, ...), registered as direct submodules so ``state_dict`` keys
read like the Flax paths.

PyTorch needs every layer's input width and kernel shape when the module
is built, where Flax infers them at the first call, so the generator is
told whether UNet skips will come (``unet``) and which input it takes:
the encoder's [B,4,4,C] code (translation; ``block_4_conv0`` a k3 SAME
conv) or, with ``noise_input=True``, [B,C] or [B,1,1,C] noise of
``noise_shape`` (generation), padded to 7x7 for a k4 VALID
``block_4_conv0``, as the JAX generator picks from the input's shape.

Every conv -> leaky -> pixel-norm step of the generator goes through
``ConvBlock.forward_pixel_norm``, which runs kernel B4
(``ops/fused_conv.py``) where no gradient is needed and the block has the
structure B4 computes (``norm_type="none"``, k3 SAME, bias, leaky).
``fused_scale`` takes the same route: the JAX package's fused nearest-up2
+ conv3x3 computes the function of the plain upsample and conv
(``ops/fused_scale.py``), which the port runs; with ``use_res_block`` the
JAX package keeps that unfused route too.

Batch renorm's clip (``renorm_clip``, the JAX ``NormCtx.renorm_clip``) and
the conditional norms' ``style`` are call arguments. A conditioning image
(``cond_image``, bilinear-resized to each block's resolution and
concatenated, the JAX ``_concat_cond_image``) widens the layers that take
it, so the generator and the discriminator are told its channel count
(``cond_image_channels``) when they are built, and the discriminator the
width of the label embedding it concatenates at 4x4 (``cond_embed_dim``). A generator built with
``conditional=True`` takes beta and gamma of its norms from ``style``
(``cfg.style_dim``); the encoder's norms never do, as in the JAX package,
whose encoders are never called with a style. ``EncoderClassifier`` and
``StyleEncoder`` are the style and distillation heads.

Under ``quantized_inference`` (W8A8 serving, ``ops/quant.py``) every
conv of the encoder, the generator and the heads records its input's
abs-max ("calib") or runs the int8 kernel Q1 ("int8"); with
``fused_scale`` the generator's conv0 then takes the pre-upsample tensor
and the conditioning image and UNet skip apart, as the JAX generator's
fused route does (``EqConv(up=True)``). The discriminator refuses the
option: it is inference-only.

The modules take and return NHWC tensors and compute on NCHW views. The
encoder and the generator are built in eval mode (norms use moving
statistics); a trainer switches them to train mode, where norms take batch
moments and ``update=True`` moves the moving statistics and the spectral
norms' ``u`` (``models/layers.py``). The discriminator has no norms; its
``update=True`` moves its spectral norms' ``u``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch.models.config import PGGANConfig, require_inference_only
from twingan_tpu_torch.models.layers import (
    ConvBlock,
    EqDense,
    ResBlockAdd,
    SelfAttention,
    torch_dtype,
)

Clip = Optional[Mapping[str, float]]
from twingan_tpu_torch import parallel
from twingan_tpu_torch.ops import basic


def noise_shape(cfg: PGGANConfig, batch_size: int) -> tuple[int, int, int, int]:
    """The generation input's shape, [B,1,1,noise_dim]."""
    return (batch_size, 1, 1, cfg.noise_dim)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _cond_at(cond_image: Optional[torch.Tensor], hw: int, dtype: torch.dtype):
    """The NHWC conditioning image resized to hw (``jax.image.resize``'s
    bilinear, antialiased when it shrinks) as an NCHW tensor of ``dtype``;
    None without one."""
    if cond_image is None:
        return None
    return _nchw(basic.resize_bilinear(cond_image, hw, hw).to(dtype))


def _check_cond(name: str, built: int, t: Optional[torch.Tensor]) -> None:
    given = 0 if t is None else t.shape[-1]
    if given != built:
        raise ValueError(f"built for a {name} of width {built}, called with width {given}")


@dataclasses.dataclass
class EncoderSkips:
    """UNet skip features keyed by resolution (NHWC).

    blocks[hw]: the encoder block output at hw (before its pool).
    interp[hw]: the fade-in blended feature at hw (growing stages only); the
    generator prefers it when its channel count matches."""

    blocks: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    interp: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)

    @staticmethod
    def cat(a: "EncoderSkips", b: "EncoderSkips") -> "EncoderSkips":
        """The skips of two batches, concatenated along the batch axis."""
        return EncoderSkips(
            blocks={hw: torch.cat([t, b.blocks[hw]]) for hw, t in a.blocks.items()},
            interp={hw: torch.cat([t, b.interp[hw]]) for hw, t in a.interp.items()})

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

    def _apply_from_rgb(self, name: str, t: torch.Tensor, domain: int,
                        update: bool, clip: Clip) -> torch.Tensor:
        y = getattr(self, f"{name}_conv")(t, domain, update, clip=clip)
        if self.cfg.do_pixel_norm:
            y = basic.pixel_norm(y, dim=1)
        return getattr(self, f"{name}_res")(t, y, domain, update)

    def forward(self, x: torch.Tensor, *, alpha: float = 0.0, domain: int = 0,
                update: bool = False,
                renorm_clip: Clip = None) -> tuple[torch.Tensor, EncoderSkips]:
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
            shrunk = self._apply_from_rgb(f"from_rgb_{src_hw // 2}", shrunk, domain, update,
                                          renorm_clip)
        net = self._apply_from_rgb(f"from_rgb_{src_hw}", x, domain, update, renorm_clip)

        for stage in range(max_stage, 0, -1):
            hw = src_hw >> (max_stage - stage)
            if cfg.do_self_attention and hw == cfg.self_attention_hw:
                net = getattr(self, f"self_attention_{hw}")(net, domain, update,
                                                            clip=renorm_clip)
            y = getattr(self, f"block_{hw}_conv0")(net, domain, update, clip=renorm_clip)
            if cfg.do_pixel_norm:
                y = basic.pixel_norm(y, dim=1)
            y = getattr(self, f"block_{hw}_conv1")(y, domain, update, clip=renorm_clip)
            if cfg.do_pixel_norm:
                y = basic.pixel_norm(y, dim=1)
            net = getattr(self, f"block_{hw}_res")(net, y, domain, update)
            skips.blocks[hw] = _nhwc(net)
            net = basic.avg_pool_2x(net, nchw=True)
            if stage == max_stage and cfg.is_growing:
                net = basic.blend(net, shrunk, alpha)
                skips.interp[hw // 2] = _nhwc(net)
        return _nhwc(net), skips


class Generator(nn.Module):
    """PGGAN generator: the [B,4,4,channels(0)] code (and UNet skips when
    ``unet``) -> [B,res,res,image_channels] for translation; with
    ``noise_input``, [B,noise_dim] or [B,1,1,noise_dim] noise instead. With
    ``conditional`` (and ``cfg.style_dim``) every norm takes the call's
    ``style``."""

    def __init__(self, cfg: PGGANConfig, unet: bool = False, noise_input: bool = False,
                 conditional: bool = False, cond_image_channels: int = 0):
        super().__init__()
        self.cfg = cfg
        self.unet = unet
        self.noise_input = noise_input
        self.conditional = conditional and cfg.style_dim > 0
        self.cond_image_channels = cond_image_channels
        ch0 = cfg.channels(0)
        block = self._block
        if noise_input:
            self.add_module("block_4_conv0", block(cfg.noise_dim, ch0, kernel_size=4,
                                                   padding="VALID"))
        else:
            self.add_module("block_4_conv0", block(ch0, ch0))
        self.add_module("block_4_conv1", block(ch0 + cond_image_channels, ch0))
        self._maybe_attention(4, ch0)
        for stage in range(1, cfg.max_stage + 1):
            hw = 2 ** (stage + 2)
            ch, prev = cfg.channels(stage), cfg.channels(stage - 1)
            if stage == cfg.max_stage and cfg.is_growing:
                self._to_rgb(hw // 2, prev)
            in_ch = prev + cond_image_channels + (prev if self._has_skip(hw) else 0)
            self.add_module(f"block_{hw}_conv0", block(in_ch, ch))
            self.add_module(f"block_{hw}_conv1", block(ch, ch))
            self.add_module(f"block_{hw}_res", ResBlockAdd(cfg, in_ch, ch))
            self._maybe_attention(hw, ch)
        self._to_rgb(cfg.resolution, cfg.channels(cfg.max_stage))
        self.eval()

    def _block(self, *args, **kw) -> ConvBlock:
        return ConvBlock(self.cfg, *args, conditional=self.conditional, **kw)

    def _has_skip(self, hw: int) -> bool:
        limit = self.cfg.unet_max_concat_hw
        return self.unet and not (limit and hw > limit)

    def _maybe_attention(self, hw: int, channels: int) -> None:
        if self.cfg.do_self_attention and hw == self.cfg.self_attention_hw:
            self.add_module(f"self_attention_{hw}", SelfAttention(
                self.cfg, channels, conditional=self.conditional))

    def _split_up(self, block: ConvBlock) -> bool:
        """Whether conv0 of a block takes the pre-upsample tensor and the
        aux input apart: under a quantize mode with ``fused_scale`` (and no
        residual blocks, which need the upsampled input), as the JAX
        generator's fused route does, so that the int8 conv quantizes the
        pre-upsample tensor and the aux input with their own scales."""
        cfg = self.cfg
        return cfg.fused_scale and not cfg.use_res_block and block.conv.quantize != ""

    def _rgb_kernel(self, hw: int) -> int:
        return min(7, hw // 2) if self.cfg.use_larger_filter_at_rgb_layer else 1

    def _to_rgb(self, hw: int, in_ch: int) -> None:
        self.add_module(f"to_rgb_{hw}", self._block(
            in_ch, self.cfg.image_channels, kernel_size=self._rgb_kernel(hw), activation=None))

    def forward(self, source: torch.Tensor, *, alpha: float = 0.0, domain: int = 0,
                unet_skips: Optional[EncoderSkips] = None, update: bool = False,
                style: Optional[torch.Tensor] = None,
                renorm_clip: Clip = None,
                cond_image: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if self.conditional and style is None:
            raise ValueError("a generator built with conditional=True takes a style vector")
        _check_cond("cond_image", self.cond_image_channels, cond_image)
        ctx = dict(style=style if self.conditional else None, clip=renorm_clip)

        def conv(hw: int, i: int, x: torch.Tensor, **kw) -> torch.Tensor:
            """``block_{hw}_conv{i}``, then the pixel norm when it is on."""
            block = getattr(self, f"block_{hw}_conv{i}")
            if cfg.do_pixel_norm:
                return block.forward_pixel_norm(x, domain, update, **ctx, **kw)
            return block(x, domain, update, **ctx, **kw)

        if self.noise_input:
            if source.dim() == 2:
                source = source[:, None, None, :]
            if source.dim() != 4 or source.shape[1:3] != (1, 1):
                raise ValueError("a generator built with noise_input=True takes [B,C] or "
                                 f"[B,1,1,C] noise, got {tuple(source.shape)}")
            source = F.pad(source, (0, 0, 3, 3, 3, 3))  # 7x7: the k4 VALID conv lands on 4x4
        elif source.dim() != 4 or source.shape[1:3] != (4, 4):
            raise ValueError("a generator built for translation takes the [B,4,4,C] encoder "
                             f"code, got {tuple(source.shape)}; build it with noise_input=True "
                             "for the noise input")
        if self.unet != (unet_skips is not None):
            raise ValueError("generator built with unet=%s got unet_skips=%s"
                             % (self.unet, unet_skips is not None))
        net = _nchw(source).to(torch_dtype(cfg.dtype))
        prev_rgb = None

        net = conv(4, 0, net)
        if cond_image is not None:
            net = torch.cat([net, _cond_at(cond_image, 4, net.dtype)], dim=1)
        net = conv(4, 1, net)
        if cfg.do_self_attention and cfg.self_attention_hw == 4:
            net = self.self_attention_4(net, domain, update, **ctx)

        for stage in range(1, cfg.max_stage + 1):
            hw = 2 ** (stage + 2)
            if stage == cfg.max_stage and cfg.is_growing:
                prev_rgb = getattr(self, f"to_rgb_{hw // 2}")(net, domain, update, **ctx)
                prev_rgb = basic.upsample_nearest_2x(prev_rgb, nchw=True)
            aux = []
            if cond_image is not None:
                aux.append(_cond_at(cond_image, hw, net.dtype))
            if self._has_skip(hw):
                skip = unet_skips.lookup(hw, cfg.channels(stage - 1))
                aux.append(_nchw(skip).to(net.dtype))
            if self._split_up(getattr(self, f"block_{hw}_conv0")):
                inp = None
                y = conv(hw, 0, net, aux=torch.cat(aux, dim=1) if aux else None, up=True)
            else:
                inp = torch.cat([basic.upsample_nearest_2x(net, nchw=True)] + aux, dim=1)
                y = conv(hw, 0, inp)
            y = conv(hw, 1, y)
            net = getattr(self, f"block_{hw}_res")(inp, y, domain, update)
            if cfg.do_self_attention and hw == cfg.self_attention_hw:
                net = getattr(self, f"self_attention_{hw}")(net, domain, update, **ctx)

        rgb = getattr(self, f"to_rgb_{cfg.resolution}")(net, domain, update, **ctx)
        out = basic.blend(rgb, prev_rgb, alpha) if cfg.is_growing else rgb
        return _nhwc(out)


class Discriminator(nn.Module):
    """PGGAN discriminator: from_rgb -> mirrored blocks with avg-pool
    downsampling (fade-in blend on a growing stage, self-attention at
    ``self_attention_hw``) -> minibatch stddev -> k3 and k4 VALID convs ->
    the linear ``prediction``. No norms; every conv has a bias. Returns the
    [B, 1] prediction in ``cfg.dtype``. Under a process group the
    minibatch stddev spans every process's rows (``ops.basic``), and
    context-parallel attention splits the positions (``SelfAttention``).

    ``attention`` is the self-attention route (``ops.attention``): "kernel"
    for the CUDA kernels, "plain" for the twice-differentiable plain version
    that the gradient penalty needs. Under ``cfg.spectral_norm`` every conv
    and the prediction divide their kernels by sigma; ``update=True`` stores
    each power iteration's ``u``.

    Built with ``do_gdrop``, a discriminator in train mode multiplies the
    inputs of each block's two convs and of the two ``before_fc`` convs by
    gdrop noise (``ops.basic.gdrop``), in the JAX draw order: one [B, C]
    tensor per site in ``gdrop_noise`` (``gdrop_shapes`` gives them), which
    the caller draws before the call (the trainers at the global batch,
    ``train/base.py``), so that a recompute under remat reads the same
    noise.
    ``cond_embed`` [B, cond_embed_dim] is broadcast over the 4x4 map and
    concatenated before the minibatch stddev; ``cond_image`` is resized to
    the input and concatenated to it."""

    def __init__(self, cfg: PGGANConfig, do_gdrop: bool = False, cond_embed_dim: int = 0,
                 cond_image_channels: int = 0):
        super().__init__()
        require_inference_only(cfg, "the discriminator")
        self.cfg = cfg
        self.do_gdrop = do_gdrop
        self.cond_embed_dim = cond_embed_dim
        self.cond_image_channels = cond_image_channels
        max_stage = cfg.max_stage
        res = cfg.resolution
        self._from_rgb(f"from_rgb_{res}", self._channels(max_stage))
        if cfg.is_growing:
            self._from_rgb(f"from_rgb_{res // 2}", self._channels(max_stage - 1))
        for stage in range(max_stage, 0, -1):
            hw = res >> (max_stage - stage)
            in_ch, ch_out = self._channels(stage), self._channels(stage - 1)
            if cfg.do_self_attention and hw == cfg.self_attention_hw:
                self.add_module(f"self_attention_{hw}",
                                SelfAttention(cfg, in_ch, discriminator=True))
            self.add_module(f"block_{hw}_conv0", ConvBlock(cfg, in_ch, in_ch, discriminator=True))
            self.add_module(f"block_{hw}_conv1", ConvBlock(cfg, in_ch, ch_out, discriminator=True))
            self.add_module(f"block_{hw}_res", ResBlockAdd(cfg, in_ch, ch_out, discriminator=True))
        mc = cfg.dis_max_channels
        self.before_fc_conv0 = ConvBlock(cfg, self._channels(0) + cond_embed_dim + 1, mc,
                                         discriminator=True)
        self.before_fc_conv1 = ConvBlock(cfg, mc, mc, kernel_size=4, padding="VALID",
                                         discriminator=True)
        self.prediction = EqDense(mc, 1, equalized_lr=cfg.equalized_lr,
                                  init_stddev=cfg.init_stddev, dtype=torch_dtype(cfg.dtype),
                                  spectral_norm=cfg.spectral_norm)

    def _channels(self, stage: int) -> int:
        return self.cfg.channels(stage, discriminator=True)

    def gdrop_shapes(self, batch: int) -> list[tuple[int, int]]:
        """The [B, C] shape of each gdrop site's noise, in draw order."""
        cfg = self.cfg
        shapes = []
        for stage in range(cfg.max_stage, 0, -1):
            shapes += [(batch, self._channels(stage))] * 2
        return shapes + [(batch, self._channels(0) + self.cond_embed_dim + 1),
                         (batch, cfg.dis_max_channels)]

    def _from_rgb(self, name: str, features: int) -> None:
        c = self.cfg.image_channels + self.cond_image_channels
        self.add_module(f"{name}_conv", ConvBlock(self.cfg, c, features, kernel_size=1,
                                                  discriminator=True))
        self.add_module(f"{name}_res", ResBlockAdd(self.cfg, c, features, discriminator=True))

    def forward(self, x: torch.Tensor, *, alpha: float = 0.0, stddev_groups: int = 1,
                attention: str = "kernel", update: bool = False,
                cond_embed: Optional[torch.Tensor] = None,
                cond_image: Optional[torch.Tensor] = None,
                gdrop_strength=0.0,
                gdrop_noise: Optional[list] = None) -> torch.Tensor:
        cfg = self.cfg
        max_stage = cfg.max_stage
        src_hw = x.shape[1]
        if src_hw != cfg.resolution:
            raise ValueError(f"discriminator expects {cfg.resolution} px input, got {src_hw}")
        _check_cond("cond_embed", self.cond_embed_dim, cond_embed)
        _check_cond("cond_image", self.cond_image_channels, cond_image)
        if cond_image is not None:
            resized = basic.resize_bilinear(cond_image, src_hw, src_hw).to(x.dtype)
            x = torch.cat([x, resized], dim=-1)
        x = _nchw(x).to(torch_dtype(cfg.dtype))
        if self.do_gdrop and self.training:
            if gdrop_noise is None:
                raise ValueError("a discriminator built with do_gdrop takes its noise as "
                                 "gdrop_noise in train mode (one tensor of each of "
                                 "gdrop_shapes)")
            sites = iter(gdrop_noise)

            def maybe_gdrop(t: torch.Tensor) -> torch.Tensor:
                return basic.gdrop(t, gdrop_strength, noise=next(sites), nchw=True)
        else:
            def maybe_gdrop(t: torch.Tensor) -> torch.Tensor:
                return t

        def from_rgb(name: str, t: torch.Tensor) -> torch.Tensor:
            y = getattr(self, f"{name}_conv")(t, update=update)
            return getattr(self, f"{name}_res")(t, y, update=update)

        shrunk = None
        if cfg.is_growing:
            shrunk = from_rgb(f"from_rgb_{src_hw // 2}", basic.avg_pool_2x(x, nchw=True))
        net = from_rgb(f"from_rgb_{src_hw}", x)

        for stage in range(max_stage, 0, -1):
            hw = src_hw >> (max_stage - stage)
            if cfg.do_self_attention and hw == cfg.self_attention_hw:
                net = getattr(self, f"self_attention_{hw}")(net, update=update, route=attention)
            y = getattr(self, f"block_{hw}_conv0")(maybe_gdrop(net), update=update)
            y = getattr(self, f"block_{hw}_conv1")(maybe_gdrop(y), update=update)
            net = getattr(self, f"block_{hw}_res")(net, y, update=update)
            net = basic.avg_pool_2x(net, nchw=True)
            if stage == max_stage and cfg.is_growing:
                net = basic.blend(net, shrunk, alpha)

        if cond_embed is not None:
            b, _, h, w = net.shape
            tiled = cond_embed.to(net.dtype)[:, :, None, None].expand(b, -1, h, w)
            net = torch.cat([net, tiled], dim=1)
        net = basic.minibatch_stddev(net, num_groups=stddev_groups, nchw=True,
                                     group=parallel.current_group())
        net = self.before_fc_conv0(maybe_gdrop(net), update=update)
        net = self.before_fc_conv1(maybe_gdrop(net), update=update)
        return self.prediction(net.reshape(net.shape[0], -1), update)


class EncoderClassifier(nn.Module):
    """Classification head on the [B,4,4,C] encoding: a k3 conv, a k4
    VALID conv and the linear ``prediction`` to ``output_dim``, with the
    generator's norms (the style embedding's and distillation's head).
    The prediction has a spectral norm only with
    ``spectral_norm_in_non_discriminator``, as in the JAX module."""

    def __init__(self, cfg: PGGANConfig, output_dim: int, conditional: bool = False):
        super().__init__()
        self.cfg = cfg
        mc = cfg.max_channels
        self.before_fc_conv0 = ConvBlock(cfg, cfg.channels(0), mc, conditional=conditional)
        self.before_fc_conv1 = ConvBlock(cfg, mc, mc, kernel_size=4, padding="VALID",
                                         conditional=conditional)
        self.prediction = EqDense(
            mc, output_dim, equalized_lr=cfg.equalized_lr, init_stddev=cfg.init_stddev,
            dtype=torch_dtype(cfg.dtype),
            spectral_norm=cfg.spectral_norm and cfg.spectral_norm_in_non_discriminator)
        self.eval()

    def forward(self, x: torch.Tensor, *, domain: int = 0, update: bool = False,
                style: Optional[torch.Tensor] = None,
                renorm_clip: Clip = None) -> torch.Tensor:
        """NHWC [B,4,4,C] -> [B, output_dim] in the compute dtype."""
        net = _nchw(x)
        net = self.before_fc_conv0(net, domain, update, style, renorm_clip)
        net = self.before_fc_conv1(net, domain, update, style, renorm_clip)
        return self.prediction(net.reshape(net.shape[0], -1), update)


class StyleEncoder(nn.Module):
    """The whole encoder (``body``) and an ``EncoderClassifier`` (``head``):
    images -> a style embedding [B, output_dim]."""

    def __init__(self, cfg: PGGANConfig, output_dim: int):
        super().__init__()
        self.body = Encoder(cfg)
        self.head = EncoderClassifier(cfg, output_dim)

    def forward(self, x: torch.Tensor, *, alpha: float = 0.0, domain: int = 0,
                update: bool = False, renorm_clip: Clip = None) -> torch.Tensor:
        net, _ = self.body(x, alpha=alpha, domain=domain, update=update,
                           renorm_clip=renorm_clip)
        return self.head(net, domain=domain, update=update, renorm_clip=renorm_clip)
