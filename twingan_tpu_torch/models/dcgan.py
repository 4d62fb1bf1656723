"""DCGAN generator and discriminator, as ``nn.Module``s.

Counterpart of ``twingan_tpu/models/dcgan.py``, with its layer names
(``deconv1``, ``deconv1_bn``, ..., ``logits``; ``conv1``, ``conv2_bn``,
..., ``logits_conv``):

- the generator: a [B, N] latent as 1x1 -> a k4 s1 VALID transposed conv
  to 4x4 of depth * 2^(L-1) channels -> k4 s2 SAME transposed convs
  halving the depth, each with batch norm and relu -> a last k4 s2
  transposed conv of ``depth`` channels without norm or activation -> a 1x1
  conv to the image channels; L = log2(final_size) - 1. The output is the
  logits (no tanh);
- the discriminator: k4 s2 SAME convs doubling the depth down to 1x1,
  batch norm on all but the first, leaky relu 0.2, then a 1x1 conv to the
  [B, 1] logits.

Batch norm is Flax's (momentum 0.999, epsilon 1e-5; ``plain_layers``).
The modules take and return NHWC tensors and compute on NCHW views. In
train mode the norms take the batch's moments and ``update=True`` moves
their running moments; in eval mode they use the running moments. With
``end_points=True`` the call also returns the JAX module's end points
(NHWC).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from twingan_tpu_torch.models.plain_layers import BatchNorm, Conv, ConvTranspose
from twingan_tpu_torch.ops import basic

BN_MOMENTUM = 0.999


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class DCGANGenerator(nn.Module):
    def __init__(self, depth: int = 64, final_size: int = 32, num_outputs: int = 3,
                 latent_dim: int = 64):
        super().__init__()
        if final_size < 8 or final_size & (final_size - 1):
            raise ValueError("final_size must be a power of 2, >= 8")
        self.final_size = final_size
        self.num_layers = int(math.log2(final_size)) - 1
        n = self.num_layers
        depth0 = depth * 2 ** (n - 1)
        self.deconv1 = ConvTranspose(latent_dim, depth0, 4, 1, "VALID")
        self.deconv1_bn = BatchNorm(depth0, BN_MOMENTUM)
        width = depth0
        for i in range(2, n):
            depth_i = depth * 2 ** (n - i)
            self.add_module(f"deconv{i}", ConvTranspose(width, depth_i, 4, 2, "SAME"))
            self.add_module(f"deconv{i}_bn", BatchNorm(depth_i, BN_MOMENTUM))
            width = depth_i
        self.add_module(f"deconv{n}", ConvTranspose(width, depth, 4, 2, "SAME"))
        self.logits = Conv(depth, num_outputs, 1, padding="VALID")

    def forward(self, z: torch.Tensor, *, update: bool = False, end_points: bool = False):
        """[B, latent_dim] -> NHWC [B, final_size, final_size, num_outputs]."""
        if z.dim() != 2:
            raise ValueError("DCGAN generator takes [batch, N] inputs")
        eps = {}
        net = z[:, :, None, None]
        for i in range(1, self.num_layers):
            net = getattr(self, f"deconv{i}")(net)
            net = torch.relu(getattr(self, f"deconv{i}_bn")(net, update))
            eps[f"deconv{i}"] = net
        n = self.num_layers
        net = getattr(self, f"deconv{n}")(net)
        eps[f"deconv{n}"] = net
        logits = _nhwc(self.logits(net))
        eps["logits"] = logits
        if end_points:
            return logits, {k: (v if k == "logits" else _nhwc(v)) for k, v in eps.items()}
        return logits


class DCGANDiscriminator(nn.Module):
    def __init__(self, depth: int = 64, input_size: int = 32, input_channels: int = 3):
        super().__init__()
        if input_size & (input_size - 1):
            # A non-power-of-2 size would end above 1x1 and the final
            # reshape would fold spatial positions into the batch.
            raise ValueError(f"DCGAN discriminator needs power-of-2 input, got {input_size}")
        self.input_size = input_size
        self.num_layers = int(math.log2(input_size))
        width = input_channels
        for i in range(self.num_layers):
            depth_i = depth * 2 ** i
            self.add_module(f"conv{i + 1}", Conv(width, depth_i, 4, 2, "SAME"))
            if i > 0:
                self.add_module(f"conv{i + 1}_bn", BatchNorm(depth_i, BN_MOMENTUM))
            width = depth_i
        self.logits_conv = Conv(width, 1, 1, padding="VALID")

    def forward(self, x: torch.Tensor, *, update: bool = False, end_points: bool = False):
        """NHWC [B, input_size, input_size, C] -> [B, 1] logits."""
        if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[1] != self.input_size:
            raise ValueError(f"DCGAN discriminator expects square {self.input_size} px "
                             f"input, got {tuple(x.shape)}")
        eps = {}
        net = x.permute(0, 3, 1, 2)
        for i in range(1, self.num_layers + 1):
            net = getattr(self, f"conv{i}")(net)
            if i > 1:
                net = getattr(self, f"conv{i}_bn")(net, update)
            net = basic.leaky_relu(net)
            eps[f"conv{i}"] = net
        logits = self.logits_conv(net).reshape(-1, 1)
        if end_points:
            eps = {k: _nhwc(v) for k, v in eps.items()}
            eps["logits"] = logits
            return logits, eps
        return logits
