"""pix2pix U-Net generator and PatchGAN discriminator, as ``nn.Module``s.

Counterpart of ``twingan_tpu/models/pix2pix.py``, with its layer names
(``enc<i>``, ``enc<i>_bn``, ``dec<i>``, ``dec<i>_bn``, ``out``;
``conv<i>``, ``conv<i>_bn``, ``logits``):

- the generator, for square power-of-2 inputs of at least 8 px: log2(hw)
  encoder levels (k4 s2 SAME convs of base * min(2^i, 8) filters, batch
  norm on all but the first, leaky relu 0.2), a mirrored decoder (k4 s2
  SAME transposed convs, batch norm, dropout 0.5 on the first three levels
  in train mode, relu, then the encoder's skip concatenated), and a k4 s2
  transposed conv to the outputs with tanh;
- the 70x70 PatchGAN: three k4 s2 convs and one k4 s1 conv (1x, 2x, 4x,
  8x the base filters; batch norm on all but the first, leaky relu), a k4
  s1 conv to the patch logits, and their mean per example ([B, 1]). The
  stride-1 k4 SAME convs pad (1, 2), more at the bottom and right
  (``plain_layers.Conv`` pads explicitly).

Batch norm is Flax's default (momentum 0.99, epsilon 1e-5). Train-mode
dropout multiplies by ``mask / 0.5``, with a keep mask of probability 0.5
per element: the caller passes the masks as ``dropout_masks`` (a list of
three NHWC bool tensors of the first three decoder levels' shapes, as
``dropout_shapes`` gives them), or they are drawn from ``generator``.
Neither package wires pix2pix into a trainer.

The modules take and return NHWC tensors and compute on NCHW views; with
``end_points=True`` the call also returns the JAX module's end points.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from twingan_tpu_torch.models.plain_layers import BatchNorm, Conv, ConvTranspose
from twingan_tpu_torch.ops import basic

DROPOUT_RATE = 0.5
DROPOUT_LEVELS = 3


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Pix2PixGenerator(nn.Module):
    def __init__(self, base_filters: int = 64, num_outputs: int = 3, input_size: int = 256,
                 input_channels: int = 3):
        super().__init__()
        if input_size < 8 or input_size & (input_size - 1):
            # A truncated log2 would desync the skips from the decoder.
            raise ValueError(f"pix2pix needs power-of-2 input of at least 8 px, "
                             f"got {input_size}")
        self.input_size = input_size
        self.levels = levels = int(math.log2(input_size))
        widths = []
        width = input_channels
        for i in range(levels):
            f = base_filters * min(2 ** i, 8)
            self.add_module(f"enc{i}", Conv(width, f, 4, 2, "SAME"))
            if i > 0:
                self.add_module(f"enc{i}_bn", BatchNorm(f))
            widths.append(f)
            width = f
        for i in range(levels - 1):
            f = base_filters * min(2 ** (levels - 2 - i), 8)
            self.add_module(f"dec{i}", ConvTranspose(width, f, 4, 2, "SAME"))
            self.add_module(f"dec{i}_bn", BatchNorm(f))
            width = f + widths[levels - 2 - i]
        self.out = ConvTranspose(width, num_outputs, 4, 2, "SAME")

    def dropout_shapes(self, batch: int) -> list[tuple[int, ...]]:
        """The NHWC shapes of the dropout masks, one per dropout level."""
        shapes = []
        for i in range(min(DROPOUT_LEVELS, self.levels - 1)):
            hw = 2 ** (i + 1)
            shapes.append((batch, hw, hw, getattr(self, f"dec{i}").kernel.shape[0]))
        return shapes

    def forward(self, x: torch.Tensor, *, update: bool = False,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None, end_points: bool = False):
        """NHWC [B, hw, hw, C] -> NHWC [B, hw, hw, num_outputs] in [-1, 1]."""
        if x.shape[1] != x.shape[2] or x.shape[1] != self.input_size:
            raise ValueError(f"pix2pix expects square {self.input_size} px input, "
                             f"got {tuple(x.shape)}")
        if self.training and dropout_masks is None:
            dropout_masks = [torch.rand(s, generator=generator, device=x.device) < 1 - DROPOUT_RATE
                             for s in self.dropout_shapes(x.shape[0])]
        eps, skips = {}, []
        net = x.permute(0, 3, 1, 2)
        for i in range(self.levels):
            net = getattr(self, f"enc{i}")(net)
            if i > 0:
                net = getattr(self, f"enc{i}_bn")(net, update)
            net = basic.leaky_relu(net)
            skips.append(net)
            eps[f"enc{i}"] = net
        for i in range(self.levels - 1):
            net = getattr(self, f"dec{i}_bn")(getattr(self, f"dec{i}")(net), update)
            if self.training and i < DROPOUT_LEVELS:
                keep = dropout_masks[i].to(net.device).permute(0, 3, 1, 2)
                net = torch.where(keep, net / (1 - DROPOUT_RATE), torch.zeros_like(net))
            net = torch.relu(net)
            net = torch.cat([net, skips[self.levels - 2 - i]], dim=1)
            eps[f"dec{i}"] = net
        out = _nhwc(torch.tanh(self.out(net)))
        if end_points:
            eps = {k: _nhwc(v) for k, v in eps.items()}
            eps["output"] = out
            return out, eps
        return out


class Pix2PixDiscriminator(nn.Module):
    """70x70 PatchGAN: 3 stride-2 convs, 1 stride-1, a patch logits map."""

    LAYERS = ((1, 2), (2, 2), (4, 2), (8, 1))

    def __init__(self, base_filters: int = 64, input_channels: int = 6):
        super().__init__()
        width = input_channels
        for i, (f, s) in enumerate(self.LAYERS):
            self.add_module(f"conv{i}", Conv(width, base_filters * f, 4, s, "SAME"))
            if i > 0:
                self.add_module(f"conv{i}_bn", BatchNorm(base_filters * f))
            width = base_filters * f
        self.logits = Conv(width, 1, 4, 1, "SAME")

    def forward(self, x: torch.Tensor, *, update: bool = False, end_points: bool = False):
        """NHWC [B, H, W, C] -> [B, 1], the mean of the patch logits."""
        eps = {}
        net = x.permute(0, 3, 1, 2)
        for i in range(len(self.LAYERS)):
            net = getattr(self, f"conv{i}")(net)
            if i > 0:
                net = getattr(self, f"conv{i}_bn")(net, update)
            net = basic.leaky_relu(net)
            eps[f"conv{i}"] = net
        logits = self.logits(net)
        pred = logits.reshape(x.shape[0], -1).mean(dim=1, keepdim=True)
        if end_points:
            eps = {k: _nhwc(v) for k, v in eps.items()}
            eps["patch_logits"] = _nhwc(logits)
            return pred, eps
        return pred
