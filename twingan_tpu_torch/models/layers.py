"""Building blocks of the PGGAN networks, as ``nn.Module``s.

Counterpart of ``twingan_tpu/models/layers.py`` (EqConv, EqDense,
DomainNorm, ConvBlock, ResBlockAdd, SelfAttention) with the same parameter
names, so a Flax tree maps onto ``state_dict`` keys one to one
(``bridge.py``): ``conv.kernel`` (stored OIHW), ``conv.bias``,
``kernel``/``bias`` of a dense layer (stored [in, out] as in Flax),
``norm.beta_%d``, ``norm.gamma_%d`` (or, for conditional norms,
``norm.beta_fc_kernel_%d``/``beta_fc_bias_%d``/``gamma_fc_kernel_%d``/
``gamma_fc_bias_%d``, the kernels [style_dim, C] as in Flax), buffers
``norm.moving_mean_%d``/``norm.moving_var_%d`` (and batch renorm's
``norm.renorm_mean_%d``, ``renorm_mean_weight_%d`` (0-d),
``renorm_stddev_%d``, ``renorm_stddev_weight_%d`` (0-d)), the spectral
norm's ``conv.u``/``u`` buffer, the int8 calibration's ``conv.a_max``
buffer (the Flax ``quant`` collection; only under a quantize mode),
``sa_gamma``.

Modules take NCHW tensors (the NHWC inputs of the public functions arrive
as NCHW views of the same memory). Parameters are fp32; activations are
computed in ``cfg.dtype`` and norm statistics in fp32, as in the JAX layers.

State follows the module's mode and the call, as the JAX ``train`` flag
and ``apply_model(update_state=...)`` do: in eval mode batch norm and
batch renorm use the moving statistics; in train mode (``.train()``) they
normalize with the batch moments (renorm corrected by r and d against the
bank's renorm state), and they move their statistics only when the call
passes ``update=True``, never as a side effect of the mode. A spectral
norm runs one power iteration in every call and stores the new ``u`` only
under ``update=True``. Every write happens after the call has read the
state it computes with, so passes that run one after another see the
state each earlier updating pass left, as the JAX trainers thread it.

The call-time context of the JAX ``NormCtx`` is passed as arguments:
``domain`` (the bank), ``update``, ``style`` (the conditional norms'
[B, style_dim] vector) and ``clip`` (batch renorm's rmax/rmin/dmax; the
schedule's last values when None).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch import parallel
from twingan_tpu_torch.models.config import NORM_TYPES, PGGANConfig
from twingan_tpu_torch.models.plain_layers import PLAIN_LAYERS
from twingan_tpu_torch.ops import attention, basic, fused_conv, norms, quant, sn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def same_padding(kernel_size: int) -> tuple[int, int]:
    """(before, after) of TF 'SAME' padding at stride 1; uneven for even
    kernels, which the larger to_rgb filters can have."""
    total = kernel_size - 1
    return total // 2, total - total // 2


QUANTIZE_MODES = ("", "calib", "int8")


def upsample_concat(x: torch.Tensor, aux: Optional[torch.Tensor]) -> torch.Tensor:
    """cat(nearest_up2(x), aux) along the channels (NCHW), aux in x's type:
    the input of a fused-scale conv0."""
    up = basic.upsample_nearest_2x(x, nchw=True)
    return up if aux is None else torch.cat([up, aux.to(up.dtype)], dim=1)


class _SpectralWeight:
    """The kernel of a layer, divided by its largest singular value when
    the layer has a spectral norm (``u`` buffer)."""

    def _init_spectral(self, spectral_norm: bool, features: int) -> None:
        self.spectral_norm = spectral_norm
        if spectral_norm:
            self.register_buffer("u", torch.full((features,), features ** -0.5))

    def _reset_spectral(self, generator: torch.Generator) -> None:
        if self.spectral_norm:
            u = torch.randn(self.u.shape, generator=generator)
            self.u.copy_(u / (torch.linalg.vector_norm(u) + 1e-12))

    def weight(self, update: bool = False) -> torch.Tensor:
        """The kernel to compute with: W, or W / sigma after one power
        iteration from ``u``, whose result is stored under ``update``."""
        if not self.spectral_norm:
            return self.kernel
        w, new_u = sn.spectral_normalize(self.kernel, self.u)
        if update:
            with torch.no_grad():
                self.u.copy_(new_u)
        return w


class EqConv(nn.Module, _SpectralWeight):
    """Conv2D with optional equalized-lr input scaling and spectral norm.

    Under equalized lr the kernel is drawn from N(0, 1) and the *input* is
    scaled by sqrt(2 / (in_channels * k^2)) at run time (the total fan-in,
    UNet skip channels included); otherwise the kernel is N(0, init_stddev).
    With ``spectral_norm`` the kernel is divided by sigma (``weight``).

    ``quantize`` is the W8A8 serving mode (the JAX ``EqConv.quantize``,
    ``ops/quant.py``): "" (off), "calib" or "int8". Under a mode the layer
    has an fp32 buffer ``a_max`` [2], the running abs-max of its input and
    of its aux input; under "" it has none, so the state-dict keys stay
    those of the fp layer. "calib" records ``max|x|`` of the tensor as it
    arrives (before the dtype cast and the eq-lr scale) and then runs the fp
    path unchanged; "int8" folds the eq-lr scale into the fp32 kernel (after
    spectral norm's W / sigma), quantizes kernel and input and runs kernel
    Q1. ``set_quantize`` changes the mode, adding the buffer where needed.

    ``up=True`` (quantize modes only: the generator's fused-scale conv0)
    takes the pre-upsample tensor as ``x`` and the rest of the input
    (conditioning image, UNet skip) as ``aux``, and computes the conv of
    ``cat(nearest_up2(x), aux)``; under "int8" as the JAX layer does, an
    input-dilated 4x4 conv of ``x`` on V = up2_conv_kernel(W[:, :cx]) with
    V's own per-channel scales plus a 3x3 conv of ``aux``, each quantized
    with its own activation scale (``a_max[0]``, ``a_max[1]``).

    Under "int8" the weight-only work (W / sigma, the eq-lr scale, the up
    kernel, ``weight_quant`` and Q1's weight layout) and the per-activation
    values (the reciprocal of the scale, ``(s_x * s_w).dtype``, the bias in
    dtype) are kept between forwards while the tensors they come from are
    unchanged: the same tensors at the same versions, device and dtype, so
    an in-place copy (``load_state_dict``, ``bridge.py``), a raised
    ``a_max``, a move to another device or type, or ``set_quantize`` takes
    effect on the next forward (a write through ``.data``, which bypasses
    the version counter, would not). The kept values are plain attributes,
    not in ``state_dict``; under tracing (``torch.export``) the module's
    tensors are others, so they are recomputed in the graph.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: str = "SAME", use_bias: bool = True,
                 equalized_lr: bool = False, init_stddev: float = 0.02,
                 dtype: torch.dtype = torch.float32, spectral_norm: bool = False,
                 quantize: str = ""):
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
        self._init_spectral(spectral_norm, features)
        self.quantize = ""
        # The a_max slots a calib pass has written: 0, and 1 with an aux input.
        self.calib_slots: set[int] = set()
        # name -> (key, sources, value) of the int8 path's kept values.
        self._int8_kept: dict = {}
        self.set_quantize(quantize)

    def set_quantize(self, mode: str) -> None:
        """Switch the quantize mode; a mode needs the ``a_max`` buffer, which
        starts at zero where the layer has none yet."""
        if mode not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {mode!r}")
        if mode and not hasattr(self, "a_max"):
            self.register_buffer("a_max", torch.zeros(2, device=self.kernel.device))
        self.quantize = mode
        self._int8_kept.clear()

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.normal_(0.0, self.init_stddev, generator=generator)
            if self.bias is not None:
                self.bias.zero_()
            self._reset_spectral(generator)

    @property
    def input_scale(self) -> float:
        """The run-time input scale: sqrt(2 / (in_channels * k^2)) under
        equalized lr, else 1."""
        if not self.equalized_lr:
            return 1.0
        return basic.equalized_lr_scale(self.in_channels, self.kernel_size)

    def conv_padding(self) -> tuple[int, int, int, int]:
        """(top, bottom, left, right) of this layer's conv."""
        if self.padding == "VALID":
            return (0, 0, 0, 0)
        before, after = same_padding(self.kernel_size)
        return (before, after, before, after)

    def observe(self, x: torch.Tensor, aux: Optional[torch.Tensor] = None) -> None:
        """Under "calib", raise ``a_max`` to the abs-max of x (and aux)."""
        if self.quantize != "calib":
            return
        with torch.no_grad():
            zero = torch.zeros((), device=x.device)
            cur = torch.stack([x.detach().abs().amax().float(),
                               aux.detach().abs().amax().float() if aux is not None else zero])
            self.a_max.copy_(torch.maximum(self.a_max, cur))
        self.calib_slots |= {0} if aux is None else {0, 1}

    def forward(self, x: torch.Tensor, update: bool = False,
                aux: Optional[torch.Tensor] = None, up: bool = False) -> torch.Tensor:
        if up and not self.quantize:
            raise ValueError("EqConv(up=True) is the fused-scale route of a quantize mode")
        if self.quantize == "int8":
            return self._int8_forward(x, aux, up)
        self.observe(x, aux)
        kernel = self.weight(update)
        if up:
            x = upsample_concat(x, aux)
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
        y = F.conv2d(x, kernel.to(self.dtype), padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y

    def _int8_kept_value(self, name, sources: tuple, make):
        """``make()``, kept while ``sources`` (tensors or None) are the same
        tensors at the same versions, device and dtype. A traced forward
        (``torch.export``) sees stand-ins of another tensor type: it makes
        its values in the graph and keeps none."""
        if any(type(t) not in (torch.Tensor, nn.Parameter) for t in sources if t is not None):
            return make()
        key = tuple(None if t is None else (id(t), t._version, t.device, t.dtype)
                    for t in sources)
        kept = self._int8_kept.get(name)
        if kept is not None and kept[0] == key:
            return kept[2]
        with torch.no_grad():
            value = make()
        self._int8_kept[name] = (key, sources, value)  # sources held: their ids stay theirs
        return value

    def _int8_weights(self, up: bool, cx: int, aux: bool):
        """(Q1's int8 weights, s_w) of the conv, or with ``up`` those of
        V = up2_conv_kernel(W[:, :cx]) and, with ``aux``, of W[:, cx:]."""
        kernel = self.weight().float()
        if self.equalized_lr:
            # conv(s x, W) == conv(x, s W): the calibrated scale applies to x
            # exactly as recorded.
            kernel = kernel * self.input_scale
        if not up:
            return (quant.conv_prep(kernel),)
        v = quant.conv_prep(quant.up2_conv_kernel(kernel[:, :cx]))
        return (v, quant.conv_prep(kernel[:, cx:])) if aux else (v,)

    def _int8_forward(self, x: torch.Tensor, aux: Optional[torch.Tensor],
                      up: bool) -> torch.Tensor:
        dt = self.dtype
        cx, has_aux = x.shape[1], up and aux is not None
        w_sources = (self.kernel, self.u if self.spectral_norm else None)
        prep = self._int8_kept_value(("weights", up, cx, has_aux), w_sources,
                                     lambda: self._int8_weights(up, cx, has_aux))
        bias = self.bias if not has_aux else None
        scales = self._int8_kept_value(
            ("scales", up, cx, has_aux, dt), (*w_sources, self.a_max, self.bias),
            lambda: [quant.conv_scales(self.a_max[i], s_w, dt, bias if i == 0 else None)
                     for i, (_, s_w) in enumerate(prep)])
        (wq, _), (rscale, scale, b) = prep[0], scales[0]
        if not up:
            return quant.conv_i8q(x, rscale, wq, scale, b, self.conv_padding(), 1, dt)
        y = quant.conv_i8q(x, rscale, wq, scale, b, (2, 2, 2, 2), 2, dt)
        if has_aux:
            (wq, _), (rscale, scale, _) = prep[1], scales[1]
            y = y + quant.conv_i8q(aux, rscale, wq, scale, None, (1, 1, 1, 1), 1, dt)
            if self.bias is not None:
                y = y + self.bias.to(dt)[:, None, None]
        return y


class EqDense(nn.Module, _SpectralWeight):
    """Dense layer with the same equalized-lr and spectral-norm treatment
    as EqConv: the input is scaled by sqrt(2 / in_features) at run time
    under equalized lr. The kernel is stored [in_features, features], the
    Flax layout."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 equalized_lr: bool = False, init_stddev: float = 0.02,
                 dtype: torch.dtype = torch.float32, spectral_norm: bool = False):
        super().__init__()
        self.in_features = in_features
        self.equalized_lr = equalized_lr
        self.init_stddev = 1.0 if equalized_lr else init_stddev
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_spectral(spectral_norm, features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.normal_(0.0, self.init_stddev, generator=generator)
            if self.bias is not None:
                self.bias.zero_()
            self._reset_spectral(generator)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        kernel = self.weight(update)
        x = x.to(self.dtype)
        if self.equalized_lr:
            scale = basic.equalized_lr_scale(self.in_features, 1)
            x = x * torch.tensor(scale, dtype=self.dtype, device=x.device)
        y = x @ kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


BN_EPS = 1e-3
BN_DECAY = 0.999
RENORM_DECAY = 0.99


class DomainNorm(nn.Module):
    """Normalization with one parameter/statistic bank per domain; the call
    selects the bank. kind: none | batch_norm (eps 1e-3) | instance_norm
    (per-sample spatial statistics, eps 1e-6) | batch_renorm (eps 1e-3) |
    layer_norm (per-sample statistics over C, H and W, eps 1e-6).

    Batch norm in train mode normalizes with the biased moments of each of
    ``num_groups`` contiguous batch groups (0 or 1: the whole batch) and,
    with ``update=True``, moves the bank's moving mean and variance toward
    the groups' mean moments (decay 0.999, no zero-debias). The moving
    variance is fed the same biased variance, which ``nn.BatchNorm2d`` would
    not do. Batch renorm multiplies each group's normalized values by r and
    adds d, both computed against the bank's renorm state as it was before
    the call; with ``update=True`` the renorm EMAs advance with the groups'
    mean moments (decay 0.99) and the moving statistics follow the debiased
    moments they imply (decay 0.99). Eval mode uses the moving statistics.

    ``conditional`` (with ``style_dim``) takes beta and gamma from per-domain
    FCs of the call's style vector, ``gamma = 1 + FC(style)``, in place of
    the bank's vectors; the JAX module decides this by whether its first
    call passed a style, so the code that builds it says so here.

    Under a process group of W processes (``parallel.current_group()``)
    each holds its rows of the batch, and ``num_groups`` counts the groups
    of the whole batch, as in the JAX package's global view: W divides it,
    each process normalizes its own num_groups / W groups, and the moving
    statistics (and renorm EMAs) advance with the mean of every process's
    group moments, one all-reduce. One group spans the processes: the
    moments of the whole batch (the mean, then the squared deviations,
    each averaged over the processes). ``sync`` (``sync_batch_norm_axis``)
    with one group takes them in the E[x^2] - E[x]^2 form instead, synced
    by one all-reduce of (mean, mean_sq) (``ops.norms.moments``); the JAX
    trainer's plain jit cannot bind the mesh axis that its pmean names."""

    def __init__(self, kind: str, num_features: int, num_domains: int = 1,
                 num_groups: int = 0, style_dim: int = 0, conditional: bool = False,
                 sync: bool = False):
        super().__init__()
        if kind not in NORM_TYPES:
            raise ValueError(f"unknown norm kind {kind!r}")
        self.kind = kind
        self.num_domains = num_domains
        self.num_groups = max(num_groups, 1)
        self.sync = sync
        self.conditional = conditional and style_dim > 0
        if kind == "none":
            return
        for d in range(num_domains):
            if self.conditional:
                for name in ("beta", "gamma"):
                    self.register_parameter(f"{name}_fc_kernel_{d}", nn.Parameter(
                        torch.zeros(style_dim, num_features)))
                    self.register_parameter(f"{name}_fc_bias_{d}", nn.Parameter(
                        torch.zeros(num_features)))
            else:
                self.register_parameter(f"beta_{d}", nn.Parameter(torch.zeros(num_features)))
                self.register_parameter(f"gamma_{d}", nn.Parameter(torch.ones(num_features)))
            if kind in ("batch_norm", "batch_renorm"):
                self.register_buffer(f"moving_mean_{d}", torch.zeros(num_features))
                self.register_buffer(f"moving_var_{d}", torch.ones(num_features))
            if kind == "batch_renorm":
                for name in norms.RENORM_STATE:
                    shape = () if name.endswith("_weight") else (num_features,)
                    self.register_buffer(f"{name}_{d}", torch.zeros(shape))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, t in list(self.named_parameters()) + list(self.named_buffers()):
                if "_fc_kernel_" in name:  # xavier uniform, as Flax's
                    limit = (6.0 / sum(t.shape)) ** 0.5
                    t.uniform_(-limit, limit, generator=generator)
                elif "_fc_bias_" in name:
                    t.zero_()
                else:
                    t.fill_(1.0 if name.startswith(("gamma_", "moving_var_")) else 0.0)

    def _affine(self, domain: int, style: Optional[torch.Tensor]):
        """(gamma, beta), broadcastable against NCHW: the bank's [C,1,1], or
        the conditional [B,C,1,1] from the style vector."""
        if not self.conditional:
            return (getattr(self, f"gamma_{domain}")[:, None, None],
                    getattr(self, f"beta_{domain}")[:, None, None])
        if style is None:
            raise ValueError("a conditional norm needs the call's style vector")
        style = style.float()
        fc = lambda name: (style @ getattr(self, f"{name}_fc_kernel_{domain}")  # noqa: E731
                           + getattr(self, f"{name}_fc_bias_{domain}"))[:, :, None, None]
        return 1.0 + fc("gamma"), fc("beta")

    def _bank(self, name: str, domain: int) -> torch.Tensor:
        return getattr(self, f"{name}_{domain}")

    def forward(self, x: torch.Tensor, domain: int, update: bool = False,
                style: Optional[torch.Tensor] = None,
                clip: Optional[Mapping[str, float]] = None) -> torch.Tensor:
        if self.kind == "none":
            return x
        gamma, beta = self._affine(domain, style)
        xf = x.float()
        if self.kind == "instance_norm":
            mean, var = norms.instance_moments(xf, nchw=True)
            return norms.normalize(xf, mean, var, gamma, beta, eps=1e-6).to(x.dtype)
        if self.kind == "layer_norm":
            mean = torch.mean(xf, dim=(1, 2, 3), keepdim=True)
            var = torch.mean(torch.square(xf - mean), dim=(1, 2, 3), keepdim=True)
            return norms.normalize(xf, mean, var, gamma, beta, eps=1e-6).to(x.dtype)
        if not self.training:
            mean = self._bank("moving_mean", domain)[:, None, None]
            var = self._bank("moving_var", domain)[:, None, None]
            return norms.normalize(xf, mean, var, gamma, beta, eps=BN_EPS).to(x.dtype)

        renorm = self.kind == "batch_renorm"
        group = parallel.current_group()
        shards = parallel.world_size(group)
        if self.num_groups == 1 and self.sync:
            mean, var = norms.moments(xf, (0, 2, 3), group)
            gmean, gvar, local, spanning = mean[None], var[None], 1, True
        elif self.num_groups % shards == 0:
            local, spanning = self.num_groups // shards, False
            gmean, gvar = norms.group_batch_moments(xf, local)  # [G / W, C]
        elif self.num_groups == 1:
            local, spanning = 1, True
            gmean, gvar = norms.group_batch_moments(xf, 1, group)
        else:
            raise ValueError(f"bn_num_groups {self.num_groups} is neither 1 nor a multiple "
                             f"of the {shards} processes")
        xg = xf.reshape(local, -1, *xf.shape[1:])
        y = norms.normalize(xg, gmean[:, None, :, None, None], gvar[:, None, :, None, None],
                            None, None, eps=BN_EPS)
        if renorm:
            clip = clip or norms.last_renorm_clip()
            state = {k: self._bank(k, domain) for k in norms.RENORM_STATE}
            r, d, _ = norms.batch_renorm_correction(gmean, gvar, state, clip,
                                                    momentum=RENORM_DECAY, eps=BN_EPS)
            y = y * r[:, None, :, None, None] + d[:, None, :, None, None]
        y = y.reshape(xf.shape) * gamma + beta
        if update:
            with torch.no_grad():
                m_mean, m_var = gmean.mean(dim=0), gvar.mean(dim=0)
                if not spanning and group is not None:
                    stacked = torch.stack([m_mean, m_var])
                    parallel.all_reduce_mean_([stacked], group)
                    m_mean, m_var = stacked.unbind(0)
                decay = BN_DECAY
                if renorm:
                    _, _, new_state = norms.batch_renorm_correction(
                        m_mean, m_var, state, clip, momentum=RENORM_DECAY, eps=BN_EPS)
                    m_mean, m_var = norms.renorm_moving_moments(new_state, eps=BN_EPS)
                    for k, v in new_state.items():
                        self._bank(k, domain).copy_(v)
                    decay = RENORM_DECAY
                for name, value in (("moving_mean", m_mean), ("moving_var", m_var)):
                    moving = self._bank(name, domain)
                    moving.copy_(norms.update_moving(moving, value, decay))
        return y.to(x.dtype)


_ACTIVATIONS = {None: None, "leaky": basic.leaky_relu, "tanh": torch.tanh}


class ConvBlock(nn.Module):
    """conv -> norm -> activation; bias exactly when no norm runs.
    ``discriminator=True`` (the discriminator's layers) and ``norm=False``
    (resblock shortcuts) run no norm. The conv has a spectral norm under
    ``cfg.spectral_norm`` in the discriminator, and everywhere with
    ``spectral_norm_in_non_discriminator``. ``conditional`` makes the norm
    take beta and gamma from the style vector (``DomainNorm``).

    ``forward_pixel_norm`` is the block followed by the pixel norm, one
    conv-leaky-pixel-norm step. A block with kernel B4's structure
    (``fusable``: k3 SAME, no norm, a bias, leaky) runs
    ``ops.fused_conv.fused_conv`` (B4) where no gradient is needed, on its
    weights (divided by sigma under a spectral norm) with the equalized-lr
    scale folded in, and this block's layers, counted under
    ``fused_conv.AUTOGRAD_ROUTE``, where one is.

    The conv takes ``cfg.quantized_inference`` as its quantize mode; with
    ``aux`` and ``up`` (the generator's fused-scale conv0 under a quantize
    mode) it takes the pre-upsample tensor and the aux input apart
    (``EqConv``)."""

    def __init__(self, cfg: PGGANConfig, in_channels: int, features: int,
                 kernel_size: int = 3, padding: str = "SAME",
                 activation: Optional[str] = "leaky", norm: bool = True,
                 discriminator: bool = False, conditional: bool = False):
        super().__init__()
        norm_kind = "none" if (discriminator or not norm) else cfg.norm_type
        use_sn = cfg.spectral_norm and (discriminator or cfg.spectral_norm_in_non_discriminator)
        self.conv = EqConv(
            in_channels, features, kernel_size, padding,
            use_bias=(norm_kind == "none"), equalized_lr=cfg.equalized_lr,
            init_stddev=cfg.init_stddev, dtype=torch_dtype(cfg.dtype), spectral_norm=use_sn,
            quantize=cfg.quantized_inference,
        )
        self.norm = DomainNorm(norm_kind, features, cfg.num_domains, cfg.bn_num_groups,
                               cfg.style_dim, conditional,
                               sync=cfg.sync_batch_norm_axis is not None)
        self.activation = _ACTIVATIONS[activation]

    @property
    def fusable(self) -> bool:
        conv = self.conv
        return (conv.kernel_size == 3 and conv.padding == "SAME" and conv.bias is not None
                and self.norm.kind == "none" and self.activation is basic.leaky_relu)

    def forward(self, x: torch.Tensor, domain: int = 0, update: bool = False,
                style: Optional[torch.Tensor] = None,
                clip: Optional[Mapping[str, float]] = None,
                aux: Optional[torch.Tensor] = None, up: bool = False) -> torch.Tensor:
        y = self.norm(self.conv(x, update, aux, up), domain, update, style, clip)
        return y if self.activation is None else self.activation(y)

    def forward_pixel_norm(self, x: torch.Tensor, domain: int = 0, update: bool = False,
                           style: Optional[torch.Tensor] = None,
                           clip: Optional[Mapping[str, float]] = None,
                           aux: Optional[torch.Tensor] = None,
                           up: bool = False) -> torch.Tensor:
        """The block, then the pixel norm. Under "int8" the block's layers
        run (Q1 in the conv), never B4, which computes the fp conv; under
        "calib" B4 may run, after the input's abs-max is recorded."""
        conv = self.conv
        if self.fusable and conv.quantize != "int8":
            if not (torch.is_grad_enabled()
                    and any(t is not None and t.requires_grad
                            for t in (x, aux, conv.kernel, conv.bias))):
                conv.observe(x, aux)
                if up:
                    x = upsample_concat(x, aux)
                return fused_conv.fused_conv(
                    x.to(conv.dtype).contiguous(),
                    fused_conv.fold_weights(conv.weight(update), conv.input_scale),
                    conv.bias.detach().float().contiguous())
            fused_conv.launch_counts[fused_conv.AUTOGRAD_ROUTE] += 1
        return basic.pixel_norm(self(x, domain, update, style, clip, aux, up), dim=1)


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

    def forward(self, inp: torch.Tensor, conv_out: torch.Tensor, domain: int = 0,
                update: bool = False) -> torch.Tensor:
        if not self.enabled:
            return conv_out
        if self.shortcut is None:
            return inp.to(conv_out.dtype) + conv_out
        return self.shortcut(inp, domain, update) + conv_out


class SelfAttention(nn.Module):
    """SAGAN self-attention: f/g 1x1 convs to C/8 channels with tanh, h 1x1
    conv to C channels, y = sa_gamma * softmax(f g^T) h + x. sa_gamma starts
    at 0, as in the JAX layer. The call's ``route`` picks the attention
    core (``ops.attention.self_attention``). With
    ``attention_context_parallel`` and a current process group of W > 1
    processes that divides N = H*W, the positions are split over the group
    (``ops.attention.context_parallel_attention``); without a group, with
    one process or with N indivisible, the local path runs, as the JAX
    layer degrades for a mesh of one device or indivisible N."""

    def __init__(self, cfg: PGGANConfig, channels: int, discriminator: bool = False,
                 conditional: bool = False):
        super().__init__()
        c_bar = max(channels // 8, 1)
        kw = dict(discriminator=discriminator, conditional=conditional)
        self.sa_f = ConvBlock(cfg, channels, c_bar, 1, activation="tanh", **kw)
        self.sa_g = ConvBlock(cfg, channels, c_bar, 1, activation="tanh", **kw)
        self.sa_h = ConvBlock(cfg, channels, channels, 1, activation=None, **kw)
        self.sa_gamma = nn.Parameter(torch.zeros(1))
        self.context_parallel = cfg.attention_context_parallel

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.sa_gamma.zero_()

    def forward(self, x: torch.Tensor, domain: int = 0, update: bool = False,
                route: str = "kernel", style: Optional[torch.Tensor] = None,
                clip: Optional[Mapping[str, float]] = None) -> torch.Tensor:
        b, c, hh, ww = x.shape

        def rows(t: torch.Tensor) -> torch.Tensor:  # NCHW -> [B, N, C'] contiguous
            return t.permute(0, 2, 3, 1).reshape(b, hh * ww, t.shape[1]).contiguous()

        f = rows(self.sa_f(x, domain, update, style, clip))
        g = rows(self.sa_g(x, domain, update, style, clip))
        h = rows(self.sa_h(x, domain, update, style, clip))
        group = parallel.current_group() if self.context_parallel else None
        shards = parallel.world_size(group)
        if shards > 1 and (hh * ww) % shards == 0:
            o = attention.context_parallel_attention(f, g, h, group, route)
        else:
            o = attention.self_attention(f, g, h, route)
        o = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.sa_gamma.to(x.dtype) * o + x


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every layer's parameters from ``generator`` with the JAX
    package's initializers (same distributions, not the same numbers)."""
    for m in module.modules():
        if isinstance(m, (EqConv, EqDense, DomainNorm, SelfAttention) + PLAIN_LAYERS):
            m.reset_parameters(generator)


@torch.no_grad()
def advance_spectral_norm(module: nn.Module) -> None:
    """One power iteration of every spectral norm in ``module``, stored:
    what one updating pass writes, without the pass. The JAX D step reads
    the discriminator's state from before the step in every pass, its one
    updating pass included, and keeps that pass's new ``u``; the port runs
    every pass without updates and then this, with the same weights."""
    for m in module.modules():
        if isinstance(m, _SpectralWeight) and m.spectral_norm:
            m.weight(update=True)
