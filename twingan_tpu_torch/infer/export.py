"""Model export: the translate function as a portable ``torch.export`` program.

Counterpart of ``twingan_tpu/infer/export.py``, whose ``export_jax``
serializes the translate closure with ``jax.export``. Here
``export_torch`` wraps an ``ImageInferer``'s encoder and generator (and
style encoder) at its fade-in alpha, domains and direction in a module
that takes the [batch, hw, hw, 3] float32 images and returns only the
translated images, traces it with ``torch.export.export(strict=False)`` on
the inferer's device and writes ``translate.pt2`` with
``torch.export.save``: the weights travel inside the program. The port's
kernels are ``torch.library`` custom ops (``twingan_tpu_torch::
flash_attn_fwd``, ``::fused_conv``, ``::conv_i8q``, ...), so the program
calls them by name; ``load_torch`` imports the modules that register them
before it loads. An inferer exported after int8 calibration
(``ImageInferer(quantize=True)`` after a batch, or ``calibrate``) exports
the int8 program, its scales among the weights.

Beside the program, ``params.npz`` holds the same variables under the JAX
export's key names (``params/<net>/...``, ``model_state/<net>/
batch_stats/...``, ``model_state/<net>/quant/...`` where calibrated),
written by the port's own inverse bridge, for the networks the program
serves.

``export_savedmodel`` (``--format=savedmodel``) writes the JAX export's
SavedModel contract: one ``serving_default`` signature on a float32 input
``sources_ph`` [batch, hw, hw, 3] (batch None, dynamic, when
``batch_size`` is 0) whose output is the translated images. It traces the
same program as ``export_torch`` (with a dynamic batch dimension when
``batch_size`` is 0) and converts its graph to TF ops
(``infer/savedmodel.py``), the weights as constants. It needs TensorFlow
(imported inside it; the card's machine has none) and maps the fp32
program only: an int8 inferer's program raises ``NotImplementedError``.

Usage:
    python -m twingan_tpu_torch.infer.export --model_path=... --output_dir=... \\
        [--format=torch|savedmodel] [--image_hw=256] [--direction=s2t|t2s] \\
        [--batch_size=1] [--device=cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from twingan_tpu_torch import bridge
from twingan_tpu_torch.train.base import fade_alpha
from twingan_tpu_torch.train.twingan_trainer import DOMAIN_S, DOMAIN_T, ENC, ENC_STYLE, GEN

PROGRAM_FILE = "translate.pt2"
PARAMS_FILE = "params.npz"


class TranslateProgram(nn.Module):
    """images [B, hw, hw, 3] float in [0, 1] -> the translated images, as
    ``ImageInferer.translate``, with the step, alpha and direction fixed: what
    ``torch.export`` traces (no dataclass output, no ``inference_mode``, no
    Python step)."""

    def __init__(self, cfg, encoder: nn.Module, generator: nn.Module,
                 encoder_style: Optional[nn.Module], direction: str, step: int):
        super().__init__()
        if direction not in ("s2t", "t2s"):
            raise ValueError(f"unknown direction {direction!r}")
        self.encoder = encoder
        self.generator = generator
        self.encoder_style = encoder_style if cfg.use_style_embedding else None
        self.use_unet = cfg.use_unet
        self.alpha = fade_alpha(cfg, step)
        self.src_domain = DOMAIN_S if direction == "s2t" else DOMAIN_T
        self.out_domain = DOMAIN_T if direction == "s2t" else DOMAIN_S

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        code, skips = self.encoder(images, alpha=self.alpha, domain=self.src_domain)
        style = None
        if self.encoder_style is not None:
            style = self.encoder_style(images, alpha=self.alpha, domain=self.src_domain)
        return self.generator(code, alpha=self.alpha, domain=self.out_domain, style=style,
                              unet_skips=skips if self.use_unet else None)


def _flat(tree: dict, prefix: str) -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def export_params(inferer) -> dict[str, np.ndarray]:
    """The inferer's networks under the JAX export's ``params.npz`` keys."""
    names = tuple(n for n in (ENC, GEN, ENC_STYLE) if hasattr(inferer.model, n))
    params, model_state = bridge.flax_train_state(inferer.model.state_dict(), names)
    return {**_flat(params, "params/"), **_flat(model_state, "model_state/")}


def trace(inferer, batch_size: int = 1):
    """``torch.export`` of the inferer's translate for [batch_size, hw, hw,
    3] float32 images on its device; batch_size 0 makes the batch dynamic
    (2 to 65535 in the program's guards, B4's grid limit; the traced graph
    computes any batch)."""
    m = inferer.model
    program = TranslateProgram(inferer.cfg, m.encoder_content, m.generator,
                               getattr(m, ENC_STYLE, None), inferer.direction, inferer.step)
    hw = inferer.image_hw
    example = torch.zeros(batch_size or 2, hw, hw, 3, device=inferer.device)
    dynamic = None
    if not batch_size:
        dynamic = ({0: torch.export.Dim("batch", min=2, max=65535)},)
    with torch.no_grad():
        return torch.export.export(program, (example,), dynamic_shapes=dynamic, strict=False)


def export_torch(inferer, output_dir: str, batch_size: int = 1) -> str:
    """Trace the inferer's translate for [batch_size, hw, hw, 3] float32
    images on its device, write ``translate.pt2`` and ``params.npz`` to
    ``output_dir``; returns the program's path."""
    os.makedirs(output_dir, exist_ok=True)
    exported = trace(inferer, batch_size)
    path = os.path.join(output_dir, PROGRAM_FILE)
    torch.export.save(exported, path)
    np.savez(os.path.join(output_dir, PARAMS_FILE), **export_params(inferer))
    return path


def export_savedmodel(inferer, output_dir: str, batch_size: int = 0) -> str:
    """The translate function as a TF SavedModel in ``output_dir``, with
    the JAX export's serving signature (module docstring). Needs
    TensorFlow."""
    from twingan_tpu_torch.infer import savedmodel

    savedmodel._tf()  # ImportError naming tensorflow before any tracing
    hw = inferer.image_hw
    return savedmodel.save(trace(inferer, batch_size), output_dir,
                           [batch_size or None, hw, hw, 3], input_name="sources_ph")


def load_torch(path: str):
    """The exported translate program at ``path`` as a callable module (call
    it under ``torch.no_grad()``)."""
    # The modules that register the kernels' custom ops.
    from twingan_tpu_torch.ops import attention, fused_conv, quant  # noqa: F401

    return torch.export.load(path).module()


def main(argv=None) -> None:
    from twingan_tpu_torch.infer.translate import ImageInferer

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True, help="stage dir or train dir")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--format", default="torch", choices=["torch", "savedmodel"])
    p.add_argument("--image_hw", type=int, default=0)
    p.add_argument("--direction", default="s2t", choices=["s2t", "t2s"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    inferer = ImageInferer(args.model_path, args.image_hw, args.direction, device=args.device)
    if args.format == "savedmodel":
        path = export_savedmodel(inferer, args.output_dir, args.batch_size)
    else:
        path = export_torch(inferer, args.output_dir, args.batch_size)
    print(f"exported to {path}")


if __name__ == "__main__":
    main()
