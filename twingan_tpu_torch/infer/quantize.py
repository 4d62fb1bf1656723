"""Post-training W8A8 quantization of a trained TwinGAN stage.

Counterpart of ``twingan_tpu/infer/quantize.py``. ``calibrate`` runs the
encoder and the generator (and the style encoder, see below) in "calib"
mode over representative source images, so that every conv records the
abs-max of its input (``EqConv.a_max``, the Flax ``quant`` collection),
then switches them to "int8": from then on every conv of the translation
runs kernel Q1 (``ops/quant.py``). Its forwards mirror the port's
``translate`` (``train/twingan_trainer.py``): the same fade-in alpha from
the stage's step, the weights the stage serves (the Polyak average where
it was trained with one), the UNet skips and the direction, so the scales
cover the tensors the int8 path will see. A stage saved without the
``quant`` buffers calibrates in place: the buffers are added at zero.

Three deliberate divergences from the JAX package, each a defect of it:

- With ``use_style_embedding``, ``calibrate`` also runs the style encoder
  in "calib" mode and hands its style to the generator; the JAX function
  skips it, and its int8 translate of such a stage fails.
- When it switches to "int8", ``calibrate`` checks once, with a single
  host sync, that every abs-max a conv used is positive (its aux slot only
  where the conv had an aux input) and raises naming the layer otherwise;
  the JAX package serves an uncalibrated layer's garbage silently. Nothing
  is checked per forward.
- ``ImageInferer(quantize=True)`` calibrates on its first batch and serves
  that batch in int8, as the JAX inferer does, but then goes on raising
  the abs-maxima, with a calib forward before each int8 forward, until it
  has seen ``CALIB_MIN_IMAGES`` images, and only then freezes the scales;
  the JAX inferer freezes them after its first batch, which through the
  server can be a single image.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
import torch.nn as nn

from twingan_tpu_torch.models.layers import EqConv
from twingan_tpu_torch.train.base import fade_alpha
from twingan_tpu_torch.train.twingan_trainer import DOMAIN_S, DOMAIN_T

# Images an ImageInferer(quantize=True) calibrates on before it freezes the
# scales (the JAX package's 256 px quality gate calibrated on 32).
CALIB_MIN_IMAGES = 64


def quantized_convs(*modules: Optional[nn.Module]) -> Iterator[tuple[str, EqConv]]:
    """(qualified name, layer) of every conv of ``modules`` (None skipped)."""
    for i, module in enumerate(modules):
        if module is None:
            continue
        for name, m in module.named_modules():
            if isinstance(m, EqConv):
                yield f"{i}:{name}", m


def set_quantize(mode: str, *modules: Optional[nn.Module]) -> None:
    """Every conv of ``modules`` to the quantize mode "", "calib" or "int8"."""
    for _, conv in quantized_convs(*modules):
        conv.set_quantize(mode)


def check_calibrated(*modules: Optional[nn.Module]) -> None:
    """Raise ``ValueError`` naming the convs whose used abs-max is not
    positive; one host sync when all are."""
    used = [(name, conv, sorted(conv.calib_slots)) for name, conv in quantized_convs(*modules)
            if conv.calib_slots]
    if not used:
        raise ValueError("no conv was calibrated: run calibrate on images first")
    values = torch.cat([conv.a_max[slots] for _, conv, slots in used])
    if bool((values > 0).all()):
        return
    bad = [f"{name} (a_max {conv.a_max.tolist()})" for name, conv, slots in used
           if not bool((conv.a_max[slots] > 0).all())]
    raise ValueError("int8 serving needs a positive abs-max at every calibrated input; "
                     "these convs saw only zeros: " + ", ".join(bad))


@torch.no_grad()
def calibrate(cfg, enc: nn.Module, gen: nn.Module, images: torch.Tensor,
              direction: str = "s2t", step: int = 0, calib_batches: int = 2,
              enc_style: Optional[nn.Module] = None,
              style: Optional[torch.Tensor] = None):
    """Record the abs-maxima of a stage's convs on ``images`` (NHWC in
    [0, 1] on the modules' device) in ``calib_batches`` slices, then switch
    the modules to "int8" and check them. Returns ``cfg`` (a
    ``TwinGANConfig``) with ``quantized_inference="int8"``; the modules are
    changed in place. Scales already recorded are kept and raised (a
    running max over calls). A stage trained with the style embedding
    calibrates ``enc_style`` too, and the generator takes its style unless
    ``style`` is given."""
    if direction not in ("s2t", "t2s"):
        raise ValueError(f"unknown direction {direction!r}")
    if cfg.use_style_embedding and enc_style is None:
        raise ValueError("a stage trained with the style embedding calibrates its style "
                         "encoder too: pass enc_style")
    src_domain = DOMAIN_S if direction == "s2t" else DOMAIN_T
    out_domain = DOMAIN_T if direction == "s2t" else DOMAIN_S
    alpha = fade_alpha(cfg, step)
    nets = (enc, gen, enc_style if cfg.use_style_embedding else None)
    set_quantize("calib", *nets)
    n = images.shape[0]
    bs = max(1, n // max(1, calib_batches))
    for i in range(0, n, bs):
        batch = images[i:i + bs]
        code, skips = enc(batch, alpha=alpha, domain=src_domain)
        batch_style = None
        if cfg.use_style_embedding:
            batch_style = nets[2](batch, alpha=alpha, domain=src_domain)
            if style is not None:
                batch_style = style[i:i + bs].to(batch.device)
        gen(code, alpha=alpha, domain=out_domain, style=batch_style,
            unet_skips=skips if cfg.use_unet else None)
    set_quantize("int8", *nets)
    check_calibrated(*nets)
    return cfg.replace(model=cfg.model.replace(quantized_inference="int8"))
