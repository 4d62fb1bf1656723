"""CycleGAN ResNet generator and discriminator, as ``nn.Module``s.

Counterpart of ``twingan_tpu/models/cyclegan.py``, with its layer names
(``input_conv.conv``, ``input_conv.norm``, ``encoder_1``, ``encoder_2``,
``block_<i>_conv0``/``conv1``, ``decoder1_deconv`` or ``decoder1_conv``/
``decoder1_norm``, ``output_conv``; the discriminator's ``prediction``):

- the shared trunk: reflect-padded VALID convs, each with instance norm
  (epsilon 1e-3, scale and bias) and relu: a 7x7 input stage, two
  stride-2 3x3 encoder stages (2x and 4x the filters), and
  ``num_resnet_blocks`` residual blocks (the second conv without relu);
- the generator's decoder, two 2x stages (2x, then 1x the filters):
  ``conv2d_transpose`` (the default) is a k3 s2 SAME transposed conv with
  relu and no instance norm, as in the reference, whose transposed conv
  sits outside the conv arg scope; ``nn_upsample_conv`` and
  ``bilinear_upsample_conv`` resize 2x (nearest, or bilinear with half-pixel
  centres: ``jax.image.resize`` at an exact 2x), reflect-pad, conv, instance
  norm and relu. Then a reflect-padded 7x7 conv to the logits, and the
  output ``tanh(logits) + tanh_linear_slope * logits``;
- the discriminator: the trunk, a spatial mean, and a dense layer to
  [B, 1].

The modules take and return NHWC tensors and compute on NCHW views. They
have no moving statistics, so train and eval mode compute the same; the
``update`` argument is accepted for the trainer's uniform call. With
``end_points=True`` the call also returns the JAX module's end points
(NHWC).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch.models.plain_layers import Conv, ConvTranspose, Dense, InstanceNorm

UPSAMPLE_METHODS = ("conv2d_transpose", "nn_upsample_conv", "bilinear_upsample_conv")


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvIN(nn.Module):
    """conv (VALID, reflect-padded by the caller) -> instance norm -> relu."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 act: bool = True):
        super().__init__()
        self.act = act
        self.conv = Conv(in_channels, features, kernel, stride, "VALID")
        self.norm = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv(x))
        return torch.relu(y) if self.act else y


class _Trunk(nn.Module):
    """The encoder and residual blocks the two networks share."""

    def __init__(self, num_filters: int, num_blocks: int, in_channels: int):
        super().__init__()
        f = num_filters
        self.num_blocks = num_blocks
        self.input_conv = ConvIN(in_channels, f, 7)
        self.encoder_1 = ConvIN(f, f * 2, 3, stride=2)
        self.encoder_2 = ConvIN(f * 2, f * 4, 3, stride=2)
        for b in range(num_blocks):
            self.add_module(f"block_{b}_conv0", ConvIN(f * 4, f * 4, 3))
            self.add_module(f"block_{b}_conv1", ConvIN(f * 4, f * 4, 3, act=False))

    def trunk(self, x: torch.Tensor, eps: dict) -> torch.Tensor:
        net = self.input_conv(_reflect_pad(x, 3))
        eps["encoder_0"] = net
        net = self.encoder_1(_reflect_pad(net, 1))
        eps["encoder_1"] = net
        net = self.encoder_2(_reflect_pad(net, 1))
        eps["encoder_2"] = net
        for b in range(self.num_blocks):
            res = getattr(self, f"block_{b}_conv0")(_reflect_pad(net, 1))
            res = getattr(self, f"block_{b}_conv1")(_reflect_pad(res, 1))
            net = net + res
            eps[f"resnet_block_{b}"] = net
        return net


class CycleGANGenerator(_Trunk):
    def __init__(self, num_filters: int = 64, num_resnet_blocks: int = 6,
                 num_outputs: int = 3, tanh_linear_slope: float = 0.0,
                 upsample_method: str = "conv2d_transpose", input_channels: int = 3):
        super().__init__(num_filters, num_resnet_blocks, input_channels)
        if upsample_method not in UPSAMPLE_METHODS:
            raise ValueError(f"unknown upsample_method {upsample_method!r}")
        self.upsample_method = upsample_method
        self.tanh_linear_slope = tanh_linear_slope
        width = num_filters * 4
        for name, features in (("decoder1", num_filters * 2), ("decoder2", num_filters)):
            if upsample_method == "conv2d_transpose":
                self.add_module(f"{name}_deconv", ConvTranspose(width, features, 3, 2, "SAME"))
            else:
                self.add_module(f"{name}_conv", Conv(width, features, 3, padding="VALID"))
                self.add_module(f"{name}_norm", InstanceNorm(features))
            width = features
        self.output_conv = Conv(width, num_outputs, 7, padding="VALID")

    def _upsample(self, net: torch.Tensor, name: str) -> torch.Tensor:
        if self.upsample_method == "conv2d_transpose":
            y = getattr(self, f"{name}_deconv")(net)
        else:
            mode = "nearest" if self.upsample_method == "nn_upsample_conv" else "bilinear"
            y = F.interpolate(net, scale_factor=2, mode=mode,
                              **({} if mode == "nearest" else {"align_corners": False}))
            y = getattr(self, f"{name}_conv")(_reflect_pad(y, 1))
            y = getattr(self, f"{name}_norm")(y)
        return torch.relu(y)

    def forward(self, x: torch.Tensor, *, update: bool = False, end_points: bool = False):
        """NHWC [B, H, W, C] (H, W divisible by 4) -> NHWC images."""
        if x.shape[1] % 4 or x.shape[2] % 4:
            raise ValueError("input size must be divisible by 4 (two stride-2 stages)")
        eps = {}
        net = self.trunk(x.permute(0, 3, 1, 2), eps)
        for name in ("decoder1", "decoder2"):
            net = self._upsample(net, name)
            eps[name] = net
        logits = self.output_conv(_reflect_pad(net, 3))
        eps["logits"] = logits
        out = torch.tanh(logits) + logits * self.tanh_linear_slope
        eps["predictions"] = out
        out = _nhwc(out)
        if end_points:
            return out, {k: _nhwc(v) for k, v in eps.items()}
        return out


class CycleGANDiscriminator(_Trunk):
    def __init__(self, num_filters: int = 64, num_resnet_blocks: int = 6,
                 input_channels: int = 3):
        super().__init__(num_filters, num_resnet_blocks, input_channels)
        self.prediction = Dense(num_filters * 4, 1)

    def forward(self, x: torch.Tensor, *, update: bool = False, end_points: bool = False):
        """NHWC images -> [B, 1]."""
        eps = {}
        net = self.trunk(x.permute(0, 3, 1, 2), eps)
        pred = self.prediction(torch.mean(net, dim=(2, 3)))
        if end_points:
            eps = {k: _nhwc(v) for k, v in eps.items()}
            eps["prediction"] = pred
            return pred, eps
        return pred
