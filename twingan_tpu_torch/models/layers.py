"""Building blocks of the PGGAN networks, as ``nn.Module``s.

Counterpart of ``twingan_tpu/models/layers.py`` (EqConv, EqDense,
DomainNorm, ConvBlock, ResBlockAdd, SelfAttention) with the same parameter
names, so a Flax tree maps onto ``state_dict`` keys one to one
(``bridge.py``): ``conv.kernel`` (stored OIHW), ``conv.bias``,
``kernel``/``bias`` of a dense layer (stored [in, out] as in Flax),
``norm.beta_%d``, ``norm.gamma_%d``, buffers
``norm.moving_mean_%d``/``norm.moving_var_%d``, ``sa_gamma``.

Modules take NCHW tensors (the NHWC inputs of the public functions arrive
as NCHW views of the same memory). Parameters are fp32; activations are
computed in ``cfg.dtype`` and norm statistics in fp32, as in the JAX layers.

Norm statistics follow the module's mode, as the JAX ``train`` flag does:
in eval mode batch norm uses the moving statistics; in train mode
(``.train()``) it normalizes with the batch moments, and it moves the
moving statistics only when the call passes ``update=True`` (the JAX
``apply_model(update_state=True)``), never as a side effect of the mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch.models.config import PGGANConfig
from twingan_tpu_torch.ops import attention, basic, fused_conv, norms

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def same_padding(kernel_size: int) -> tuple[int, int]:
    """(before, after) of TF 'SAME' padding at stride 1; uneven for even
    kernels, which the larger to_rgb filters can have."""
    total = kernel_size - 1
    return total // 2, total - total // 2


class EqConv(nn.Module):
    """Conv2D with optional equalized-lr input scaling.

    Under equalized lr the kernel is drawn from N(0, 1) and the *input* is
    scaled by sqrt(2 / (in_channels * k^2)) at run time (the total fan-in,
    UNet skip channels included); otherwise the kernel is N(0, init_stddev).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: str = "SAME", use_bias: bool = True,
                 equalized_lr: bool = False, init_stddev: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.padding = padding
        self.equalized_lr = equalized_lr
        self.init_stddev = 1.0 if equalized_lr else init_stddev
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.normal_(0.0, self.init_stddev, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    @property
    def input_scale(self) -> float:
        """The run-time input scale: sqrt(2 / (in_channels * k^2)) under
        equalized lr, else 1."""
        if not self.equalized_lr:
            return 1.0
        return basic.equalized_lr_scale(self.in_channels, self.kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.equalized_lr:
            x = x * torch.tensor(self.input_scale, dtype=self.dtype, device=x.device)
        pad = 0
        if self.padding == "SAME":
            before, after = same_padding(self.kernel_size)
            if before == after:
                pad = before
            else:
                x = F.pad(x, (before, after, before, after))
        y = F.conv2d(x, self.kernel.to(self.dtype), padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class EqDense(nn.Module):
    """Dense layer with the same equalized-lr treatment as EqConv: the input
    is scaled by sqrt(2 / in_features) at run time under equalized lr. The
    kernel is stored [in_features, features], the Flax layout."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 equalized_lr: bool = False, init_stddev: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = in_features
        self.equalized_lr = equalized_lr
        self.init_stddev = 1.0 if equalized_lr else init_stddev
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.normal_(0.0, self.init_stddev, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.equalized_lr:
            scale = basic.equalized_lr_scale(self.in_features, 1)
            x = x * torch.tensor(scale, dtype=self.dtype, device=x.device)
        y = x @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


BN_EPS = 1e-3
BN_DECAY = 0.999


class DomainNorm(nn.Module):
    """Normalization with one parameter/statistic bank per domain; the call
    selects the bank. kind: none | batch_norm (eps 1e-3) | instance_norm
    (per-sample statistics, eps 1e-6).

    Batch norm in train mode normalizes with the biased moments of each of
    ``num_groups`` contiguous batch groups (0 or 1: the whole batch) and,
    with ``update=True``, moves the bank's moving mean and variance toward
    the groups' mean moments (decay 0.999, no zero-debias). The moving
    variance is fed the same biased variance, which ``nn.BatchNorm2d`` would
    not do. Eval mode uses the moving statistics."""

    def __init__(self, kind: str, num_features: int, num_domains: int = 1,
                 num_groups: int = 0):
        super().__init__()
        if kind not in ("none", "batch_norm", "instance_norm"):
            raise NotImplementedError(f"norm_type={kind} is not ported to twingan_tpu_torch yet")
        self.kind = kind
        self.num_domains = num_domains
        self.num_groups = max(num_groups, 1)
        if kind == "none":
            return
        for d in range(num_domains):
            self.register_parameter(f"beta_{d}", nn.Parameter(torch.zeros(num_features)))
            self.register_parameter(f"gamma_{d}", nn.Parameter(torch.ones(num_features)))
            if kind == "batch_norm":
                self.register_buffer(f"moving_mean_{d}", torch.zeros(num_features))
                self.register_buffer(f"moving_var_{d}", torch.ones(num_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, t in list(self.named_parameters()) + list(self.named_buffers()):
                t.fill_(1.0 if name.startswith(("gamma_", "moving_var_")) else 0.0)

    def forward(self, x: torch.Tensor, domain: int, update: bool = False) -> torch.Tensor:
        if self.kind == "none":
            return x
        gamma = getattr(self, f"gamma_{domain}")[:, None, None]
        beta = getattr(self, f"beta_{domain}")[:, None, None]
        xf = x.float()
        if self.kind == "instance_norm":
            mean, var = norms.instance_moments(xf, nchw=True)
            y = norms.normalize(xf, mean, var, gamma, beta, eps=1e-6)
        elif self.training:
            gmean, gvar = norms.group_batch_moments(xf, self.num_groups)  # [G, C]
            xg = xf.reshape(self.num_groups, -1, *xf.shape[1:])
            y = norms.normalize(xg, gmean[:, None, :, None, None], gvar[:, None, :, None, None],
                                gamma, beta, eps=BN_EPS).reshape(xf.shape)
            if update:
                with torch.no_grad():
                    for name, value in (("moving_mean", gmean), ("moving_var", gvar)):
                        moving = getattr(self, f"{name}_{domain}")
                        moving.copy_(norms.update_moving(moving, value.mean(dim=0), BN_DECAY))
        else:
            mean = getattr(self, f"moving_mean_{domain}")[:, None, None]
            var = getattr(self, f"moving_var_{domain}")[:, None, None]
            y = norms.normalize(xf, mean, var, gamma, beta, eps=BN_EPS)
        return y.to(x.dtype)


_ACTIVATIONS = {None: None, "leaky": basic.leaky_relu, "tanh": torch.tanh}


class ConvBlock(nn.Module):
    """conv -> norm -> activation; bias exactly when no norm runs.
    ``discriminator=True`` (the discriminator's layers) and ``norm=False``
    (resblock shortcuts) run no norm.

    ``forward_pixel_norm`` is the block followed by the pixel norm, one
    conv-leaky-pixel-norm step. A block with kernel B4's structure
    (``fusable``: k3 SAME, no norm, a bias, leaky) runs
    ``ops.fused_conv.fused_conv`` (B4) where no gradient is needed, on its
    weights with the equalized-lr scale folded in, and this block's layers,
    counted under ``fused_conv.AUTOGRAD_ROUTE``, where one is."""

    def __init__(self, cfg: PGGANConfig, in_channels: int, features: int,
                 kernel_size: int = 3, padding: str = "SAME",
                 activation: Optional[str] = "leaky", norm: bool = True,
                 discriminator: bool = False):
        super().__init__()
        norm_kind = "none" if (discriminator or not norm) else cfg.norm_type
        self.conv = EqConv(
            in_channels, features, kernel_size, padding,
            use_bias=(norm_kind == "none"), equalized_lr=cfg.equalized_lr,
            init_stddev=cfg.init_stddev, dtype=torch_dtype(cfg.dtype),
        )
        self.norm = DomainNorm(norm_kind, features, cfg.num_domains, cfg.bn_num_groups)
        self.activation = _ACTIVATIONS[activation]

    @property
    def fusable(self) -> bool:
        conv = self.conv
        return (conv.kernel_size == 3 and conv.padding == "SAME" and conv.bias is not None
                and self.norm.kind == "none" and self.activation is basic.leaky_relu)

    def forward(self, x: torch.Tensor, domain: int = 0, update: bool = False) -> torch.Tensor:
        y = self.norm(self.conv(x), domain, update)
        return y if self.activation is None else self.activation(y)

    def forward_pixel_norm(self, x: torch.Tensor, domain: int = 0,
                           update: bool = False) -> torch.Tensor:
        conv = self.conv
        if self.fusable:
            x = x.to(conv.dtype)
            if not (torch.is_grad_enabled()
                    and any(t.requires_grad for t in (x, conv.kernel, conv.bias))):
                return fused_conv.fused_conv(
                    x.contiguous(), fused_conv.fold_weights(conv.kernel, conv.input_scale),
                    conv.bias.detach().float().contiguous())
            fused_conv.launch_counts[fused_conv.AUTOGRAD_ROUTE] += 1
        return basic.pixel_norm(self(x, domain, update), dim=1)


class ResBlockAdd(nn.Module):
    """Optional residual shortcut: identity when channels match, else a
    plain 1x1 conv named ``shortcut``. A no-op unless ``use_res_block``."""

    def __init__(self, cfg: PGGANConfig, in_channels: int, features: int,
                 discriminator: bool = False):
        super().__init__()
        self.enabled = cfg.use_res_block
        if self.enabled and in_channels != features:
            self.shortcut = ConvBlock(cfg, in_channels, features, kernel_size=1,
                                      activation=None, norm=False, discriminator=discriminator)
        else:
            self.shortcut = None

    def forward(self, inp: torch.Tensor, conv_out: torch.Tensor, domain: int = 0) -> torch.Tensor:
        if not self.enabled:
            return conv_out
        if self.shortcut is None:
            return inp.to(conv_out.dtype) + conv_out
        return self.shortcut(inp, domain) + conv_out


class SelfAttention(nn.Module):
    """SAGAN self-attention: f/g 1x1 convs to C/8 channels with tanh, h 1x1
    conv to C channels, y = sa_gamma * softmax(f g^T) h + x. sa_gamma starts
    at 0, as in the JAX layer. The call's ``route`` picks the attention
    core (``ops.attention.self_attention``)."""

    def __init__(self, cfg: PGGANConfig, channels: int, discriminator: bool = False):
        super().__init__()
        c_bar = max(channels // 8, 1)
        kw = dict(discriminator=discriminator)
        self.sa_f = ConvBlock(cfg, channels, c_bar, 1, activation="tanh", **kw)
        self.sa_g = ConvBlock(cfg, channels, c_bar, 1, activation="tanh", **kw)
        self.sa_h = ConvBlock(cfg, channels, channels, 1, activation=None, **kw)
        self.sa_gamma = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.sa_gamma.zero_()

    def forward(self, x: torch.Tensor, domain: int = 0, update: bool = False,
                route: str = "kernel") -> torch.Tensor:
        b, c, hh, ww = x.shape

        def rows(t: torch.Tensor) -> torch.Tensor:  # NCHW -> [B, N, C'] contiguous
            return t.permute(0, 2, 3, 1).reshape(b, hh * ww, t.shape[1]).contiguous()

        f = rows(self.sa_f(x, domain, update))
        g = rows(self.sa_g(x, domain, update))
        h = rows(self.sa_h(x, domain, update))
        o = attention.self_attention(f, g, h, route)
        o = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.sa_gamma.to(x.dtype) * o + x


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every layer's parameters from ``generator`` with the JAX
    package's initializers (same distributions, not the same numbers)."""
    for m in module.modules():
        if isinstance(m, (EqConv, EqDense, DomainNorm, SelfAttention)):
            m.reset_parameters(generator)
