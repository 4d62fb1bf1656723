"""Checkpoint-based image translation: ``ImageInferer`` and its CLI.

Counterpart of ``twingan_tpu/infer/translate.py`` with the same contract:
uint8 image -> float [0,1] -> bilinear resize to image_hw (RESHAPE) ->
batch -> encoder (source domain) -> generator (target domain), the output
returned as float32 NHWC (clipped only when saved as an image). The model
is rebuilt from the stage's config.json and model.pt; a stage trained with
the style embedding holds its style encoder there too, and translates with
the style of each source image unless a style is given.

It runs on the CUDA card unless the caller passes ``device="cpu"``; with no
card and no such request it raises, never falling back to the CPU.

``quantize=True`` (the CLI's ``--quantize``) serves the W8A8 int8 path
(``infer/quantize.py``, kernel Q1): the first batch calibrates the scales
and is served in int8, as in the JAX package; then each batch is
calibrated on before it is served, until ``CALIB_MIN_IMAGES`` images have
been seen, and the scales freeze.

Usage:
    python -m twingan_tpu_torch.infer.translate \\
        --model_path=/trained/256 --input_image_path=in.jpg \\
        --output_image_path=out.jpg [--direction=s2t|t2s] [--batch_size=8] \\
        [--quantize] [--device=cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from twingan_tpu_torch.data.converters import list_images
from twingan_tpu_torch.data.preprocess import host_resize
from twingan_tpu_torch.infer.quantize import CALIB_MIN_IMAGES, calibrate
from twingan_tpu_torch.runner.checkpoint import load_model
from twingan_tpu_torch.runner.config_io import find_latest_stage_dir, load_stage_config
from twingan_tpu_torch.train.base import resolve_device
from twingan_tpu_torch.train.twingan_trainer import (
    ENC_STYLE,
    TwinGANConfig,
    TwinGANTranslator,
    translate,
)
from twingan_tpu_torch.utils.image_io import imread_rgb, imsave_float


class ImageInferer:
    """Loads a trained stage and translates images.

    ``dtype`` overrides the config's compute dtype (e.g. "float32" for an
    exact reference run); parameters stay fp32 either way. ``quantize``
    serves the int8 path, calibrating on the first ``CALIB_MIN_IMAGES``
    images it translates (``calibrated_images`` counts them)."""

    def __init__(self, model_path: str, image_hw: int = 0, direction: str = "s2t",
                 device: Optional[str | torch.device] = None, dtype: Optional[str] = None,
                 quantize: bool = False):
        self.device = resolve_device(device)
        stage_dir = model_path
        if not os.path.exists(os.path.join(stage_dir, "config.json")):
            stage_dir = find_latest_stage_dir(model_path)
        _, tcfg = load_stage_config(stage_dir)
        if not isinstance(tcfg, TwinGANConfig):
            raise ValueError(f"{stage_dir} holds a generation stage ({type(tcfg).__name__}); "
                             "ImageInferer translates with a TwinGAN stage")
        if dtype is not None:
            tcfg = tcfg.replace(model=tcfg.model.replace(dtype=dtype))
        self.cfg = tcfg
        self.stage_dir = stage_dir
        self.direction = direction
        self.image_hw = image_hw or tcfg.model.resolution
        state_dict, self.step = load_model(stage_dir)
        model = TwinGANTranslator(tcfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device)
        self.quantize = quantize
        self.calibrated_images = 0

    def preprocess(self, image: np.ndarray) -> np.ndarray:
        """uint8 HWC -> float [0,1] at (image_hw, image_hw)."""
        return host_resize(image, "RESHAPE", self.image_hw)

    def translate(self, x: torch.Tensor, direction: Optional[str] = None,
                  style: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A float NHWC batch in [0,1] at image_hw -> the other domain, on
        the inferer's device (``direction`` defaults to the inferer's). A
        stage trained with the style embedding takes ``style`` [B,
        style_embed_size], by default its style encoder's of ``x``."""
        return translate(self.cfg, self.model.encoder_content, self.model.generator,
                         x.to(self.device), direction or self.direction, step=self.step,
                         style=style, enc_style=getattr(self.model, ENC_STYLE, None))

    def calibrate(self, x: torch.Tensor, style: Optional[torch.Tensor] = None) -> None:
        """Raise the int8 scales on a float NHWC batch in [0, 1] (two calib
        slices, as the JAX inferer's) and switch to int8."""
        m = self.model
        self.cfg = calibrate(self.cfg, m.encoder_content, m.generator, x.to(self.device),
                             self.direction, step=self.step,
                             enc_style=getattr(m, ENC_STYLE, None), style=style)
        self.calibrated_images += x.shape[0]

    def infer_batch(self, images: Sequence[np.ndarray],
                    style: Optional[torch.Tensor] = None) -> np.ndarray:
        x = torch.from_numpy(np.stack([self.preprocess(im) for im in images]))
        if self.quantize and self.calibrated_images < CALIB_MIN_IMAGES:
            self.calibrate(x, style)
        return self.translate(x, style=style).float().cpu().numpy()

    def infer(self, image_path: str, output_path: str, return_image: bool = False):
        """Translate one image file and save the result (PNG needs no PIL)."""
        out = self.infer_batch([imread_rgb(image_path)])[0]
        imsave_float(output_path, out)
        return out if return_image else None


def _iter_images(path: str) -> Iterator[str]:
    """A folder's images in ``list_images``'s order (sorted paths), or the
    one file."""
    if os.path.isdir(path):
        yield from list_images(path)
    else:
        yield path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True, help="stage dir or train dir")
    p.add_argument("--image_hw", type=int, default=0)
    p.add_argument("--input_image_path", required=True, help="image file or folder")
    p.add_argument("--output_image_path", required=True, help="output file or folder")
    p.add_argument("--direction", default="s2t", choices=["s2t", "t2s"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--quantize", action="store_true",
                   help="serve the W8A8 int8 path (kernel Q1); the scales calibrate on the "
                        f"first {CALIB_MIN_IMAGES} images translated, the first batch "
                        "included")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    inferer = ImageInferer(args.model_path, args.image_hw, args.direction, device=args.device,
                           quantize=args.quantize)
    paths = list(_iter_images(args.input_image_path))
    out_is_dir = os.path.isdir(args.input_image_path) or len(paths) > 1
    if out_is_dir:
        os.makedirs(args.output_image_path, exist_ok=True)

    t0 = time.time()
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i: i + args.batch_size]
        outs = inferer.infer_batch([imread_rgb(p_) for p_ in chunk])
        for path, out in zip(chunk, outs):
            dst = args.output_image_path
            if out_is_dir:
                rel = os.path.relpath(path, args.input_image_path)
                dst = os.path.join(args.output_image_path, rel.replace(os.sep, "_"))
            imsave_float(dst, out)
    dt = time.time() - t0
    print(f"translated {len(paths)} images in {dt:.2f}s on {inferer.device}")


if __name__ == "__main__":
    main()
