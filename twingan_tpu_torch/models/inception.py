"""Inception v1, v2, v3, v4 and Inception-ResNet-v2.

Counterpart of ``twingan_tpu/models/inception.py``, the same branch
structures, filter counts and parameter names. Every conv is
``ConvBNRelu``: a bias-free conv, a batch norm (momentum 0.9997, eps 1e-3)
and a relu. The branches' 3x3 stride-1 ``SAME`` average pools count the
padded zeros, as Flax's ``avg_pool`` does. The layers are those of
``models/classifiers.py``: NHWC in, NCHW inside, NHWC end points.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch.models.classifiers import (
    BatchNorm,
    Classifier,
    Conv,
    Dense,
    _ep,
    avg_pool,
    max_pool,
    nhwc,
)

BN_MOMENTUM = 0.9997
BN_EPS = 0.001


class ConvBNRelu(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel, strides=1,
                 padding: str = "SAME"):
        super().__init__()
        self.features = features
        self.conv = Conv(in_channels, features, kernel, strides, padding, use_bias=False)
        self.bn = BatchNorm(features, BN_MOMENTUM, BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _cat(*xs):
    return torch.cat(xs, dim=1)


class InceptionV1Block(nn.Module):
    """GoogLeNet mixed block: 1x1 | 1x1-3x3 | 1x1-5x5 (a 3x3, as the JAX
    block has it) | pool-1x1."""

    def __init__(self, in_channels: int, b0: int, b1: Sequence[int], b2: Sequence[int],
                 b3: int):
        super().__init__()
        self.b0 = ConvBNRelu(in_channels, b0, 1)
        self.b1_0 = ConvBNRelu(in_channels, b1[0], 1)
        self.b1_1 = ConvBNRelu(b1[0], b1[1], 3)
        self.b2_0 = ConvBNRelu(in_channels, b2[0], 1)
        self.b2_1 = ConvBNRelu(b2[0], b2[1], 3)
        self.b3_1 = ConvBNRelu(in_channels, b3, 1)
        self.out_channels = b0 + b1[1] + b2[1] + b3

    def forward(self, x):
        return _cat(self.b0(x), self.b1_1(self.b1_0(x)), self.b2_1(self.b2_0(x)),
                    self.b3_1(max_pool(x, 3, 1, "SAME")))


class InceptionV1(Classifier):
    PLAN = (
        ("Mixed_3b", 64, (96, 128), (16, 32), 32),
        ("Mixed_3c", 128, (128, 192), (32, 96), 64),
        ("pool", 0, (), (), 0),
        ("Mixed_4b", 192, (96, 208), (16, 48), 64),
        ("Mixed_4c", 160, (112, 224), (24, 64), 64),
        ("Mixed_4d", 128, (128, 256), (24, 64), 64),
        ("Mixed_4e", 112, (144, 288), (32, 64), 64),
        ("Mixed_4f", 256, (160, 320), (32, 128), 128),
        ("pool2", 0, (), (), 0),
        ("Mixed_5b", 256, (160, 320), (32, 128), 128),
        ("Mixed_5c", 384, (192, 384), (48, 128), 128),
    )

    def __init__(self, num_classes: int = 1000, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.Conv2d_1a_7x7 = ConvBNRelu(in_channels, 64, 7, 2)
        self.Conv2d_2b_1x1 = ConvBNRelu(64, 64, 1)
        self.Conv2d_2c_3x3 = ConvBNRelu(64, 192, 3)
        ch = 192
        for name, b0, b1, b2, b3 in self.PLAN:
            if not name.startswith("pool"):
                block = InceptionV1Block(ch, b0, b1, b2, b3)
                self.add_module(name, block)
                ch = block.out_channels
        self.Logits = Dense(ch, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = max_pool(self.Conv2d_1a_7x7(x), 3, 2, "SAME")
        x = max_pool(self.Conv2d_2c_3x3(self.Conv2d_2b_1x1(x)), 3, 2, "SAME")
        for name, *_ in self.PLAN:
            if name.startswith("pool"):
                x = max_pool(x, 3, 2, "SAME")
            else:
                x = _ep(eps, probes, name, getattr(self, name)(x))
        x = torch.mean(x, dim=(2, 3))
        eps["PreLogits"] = x
        logits = self.Logits(x)
        eps["Logits"] = logits
        return logits, eps


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.b0 = ConvBNRelu(in_channels, 64, 1)
        self.b1_0 = ConvBNRelu(in_channels, 48, 1)
        self.b1_1 = ConvBNRelu(48, 64, 5)
        self.b2_0 = ConvBNRelu(in_channels, 64, 1)
        self.b2_1 = ConvBNRelu(64, 96, 3)
        self.b2_2 = ConvBNRelu(96, 96, 3)
        self.b3_1 = ConvBNRelu(in_channels, pool_features, 1)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return _cat(self.b0(x), self.b1_1(self.b1_0(x)), self.b2_2(self.b2_1(self.b2_0(x))),
                    self.b3_1(avg_pool(x)))


class ReductionA(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.b0 = ConvBNRelu(in_channels, 384, 3, 2, "VALID")
        self.b1_0 = ConvBNRelu(in_channels, 64, 1)
        self.b1_1 = ConvBNRelu(64, 96, 3)
        self.b1_2 = ConvBNRelu(96, 96, 3, 2, "VALID")
        self.out_channels = 384 + 96 + in_channels

    def forward(self, x):
        return _cat(self.b0(x), self.b1_2(self.b1_1(self.b1_0(x))), max_pool(x, 3, 2))


class InceptionB(nn.Module):
    def __init__(self, in_channels: int, c7: int):
        super().__init__()
        c = c7
        self.b0 = ConvBNRelu(in_channels, 192, 1)
        self.b1_0 = ConvBNRelu(in_channels, c, 1)
        self.b1_1 = ConvBNRelu(c, c, (1, 7))
        self.b1_2 = ConvBNRelu(c, 192, (7, 1))
        self.b2_0 = ConvBNRelu(in_channels, c, 1)
        self.b2_1 = ConvBNRelu(c, c, (7, 1))
        self.b2_2 = ConvBNRelu(c, c, (1, 7))
        self.b2_3 = ConvBNRelu(c, c, (7, 1))
        self.b2_4 = ConvBNRelu(c, 192, (1, 7))
        self.b3_1 = ConvBNRelu(in_channels, 192, 1)
        self.out_channels = 768

    def forward(self, x):
        b1 = self.b1_2(self.b1_1(self.b1_0(x)))
        b2 = self.b2_4(self.b2_3(self.b2_2(self.b2_1(self.b2_0(x)))))
        return _cat(self.b0(x), b1, b2, self.b3_1(avg_pool(x)))


class ReductionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.b0_0 = ConvBNRelu(in_channels, 192, 1)
        self.b0_1 = ConvBNRelu(192, 320, 3, 2, "VALID")
        self.b1_0 = ConvBNRelu(in_channels, 192, 1)
        self.b1_1 = ConvBNRelu(192, 192, (1, 7))
        self.b1_2 = ConvBNRelu(192, 192, (7, 1))
        self.b1_3 = ConvBNRelu(192, 192, 3, 2, "VALID")
        self.out_channels = 320 + 192 + in_channels

    def forward(self, x):
        b1 = self.b1_3(self.b1_2(self.b1_1(self.b1_0(x))))
        return _cat(self.b0_1(self.b0_0(x)), b1, max_pool(x, 3, 2))


class InceptionC(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.b0 = ConvBNRelu(in_channels, 320, 1)
        self.b1_0 = ConvBNRelu(in_channels, 384, 1)
        self.b1_1a = ConvBNRelu(384, 384, (1, 3))
        self.b1_1b = ConvBNRelu(384, 384, (3, 1))
        self.b2_0 = ConvBNRelu(in_channels, 448, 1)
        self.b2_1 = ConvBNRelu(448, 384, 3)
        self.b2_2a = ConvBNRelu(384, 384, (1, 3))
        self.b2_2b = ConvBNRelu(384, 384, (3, 1))
        self.b3_1 = ConvBNRelu(in_channels, 192, 1)
        self.out_channels = 2048

    def forward(self, x):
        b1 = self.b1_0(x)
        b2 = self.b2_1(self.b2_0(x))
        return _cat(self.b0(x), self.b1_1a(b1), self.b1_1b(b1), self.b2_2a(b2),
                    self.b2_2b(b2), self.b3_1(avg_pool(x)))


class InceptionV3(Classifier):
    default_image_size = 299

    def __init__(self, num_classes: int = 1000, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBNRelu(in_channels, 32, 3, 2, "VALID")
        self.Conv2d_2a_3x3 = ConvBNRelu(32, 32, 3, padding="VALID")
        self.Conv2d_2b_3x3 = ConvBNRelu(32, 64, 3)
        self.Conv2d_3b_1x1 = ConvBNRelu(64, 80, 1, padding="VALID")
        self.Conv2d_4a_3x3 = ConvBNRelu(80, 192, 3, padding="VALID")
        ch = 192
        for name, pool_f in (("Mixed_5b", 32), ("Mixed_5c", 64), ("Mixed_5d", 64)):
            self.add_module(name, InceptionA(ch, pool_f))
            ch = getattr(self, name).out_channels
        self.Mixed_6a = ReductionA(ch)
        ch = self.Mixed_6a.out_channels
        for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                         ("Mixed_6e", 192)):
            self.add_module(name, InceptionB(ch, c7))
            ch = 768
        self.Mixed_7a = ReductionB(ch)
        ch = self.Mixed_7a.out_channels
        for name in ("Mixed_7b", "Mixed_7c"):
            self.add_module(name, InceptionC(ch))
            ch = 2048
        self.Logits = Dense(ch, num_classes)

    def forward(self, x: torch.Tensor, probes: Optional[dict] = None,
                stop_at: Optional[str] = None):
        """``stop_at`` ends the pass at that mixed block's end point (the
        logits are then None): the work XLA's dead-code elimination leaves
        of the JAX network when a caller reads one end point."""
        return self.net(x.permute(0, 3, 1, 2), probes, stop_at)

    def net(self, x, probes, stop_at=None):
        eps: Dict[str, Any] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x, 3, 2)
        x = max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _ep(eps, probes, name, getattr(self, name)(x))
            if name == stop_at:
                return None, eps
        x = self.Mixed_6a(x)
        eps["Mixed_6a"] = nhwc(x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _ep(eps, probes, name, getattr(self, name)(x))
        x = self.Mixed_7a(x)
        eps["Mixed_7a"] = nhwc(x)
        for name in ("Mixed_7b", "Mixed_7c"):
            x = _ep(eps, probes, name, getattr(self, name)(x))
        x = torch.mean(x, dim=(2, 3))
        eps["PreLogits"] = x
        logits = self.Logits(x)
        eps["Logits"] = logits
        return logits, eps


class InceptionV2Block(nn.Module):
    """v2 mixed block: 1x1 | 1x1-3x3 | 1x1-3x3-3x3 | pool-1x1."""

    def __init__(self, in_channels: int, b0: int, b1: Sequence[int], b2: Sequence[int],
                 b3: int, pool: str = "avg"):
        super().__init__()
        self.has_b0, self.has_b3, self.pool = bool(b0), bool(b3), pool
        if b0:
            self.b0 = ConvBNRelu(in_channels, b0, 1)
        self.b1_0 = ConvBNRelu(in_channels, b1[0], 1)
        self.b1_1 = ConvBNRelu(b1[0], b1[1], 3)
        self.b2_0 = ConvBNRelu(in_channels, b2[0], 1)
        self.b2_1 = ConvBNRelu(b2[0], b2[1], 3)
        self.b2_2 = ConvBNRelu(b2[1], b2[1], 3)
        if b3:
            self.b3_1 = ConvBNRelu(in_channels, b3, 1)
        self.out_channels = b0 + b1[1] + b2[1] + (b3 or in_channels)

    def forward(self, x):
        branches = [self.b0(x)] if self.has_b0 else []
        branches.append(self.b1_1(self.b1_0(x)))
        branches.append(self.b2_2(self.b2_1(self.b2_0(x))))
        pooled = avg_pool(x) if self.pool == "avg" else max_pool(x, 3, 1, "SAME")
        branches.append(self.b3_1(pooled) if self.has_b3 else pooled)
        return _cat(*branches)


class InceptionV2Reduction(nn.Module):
    def __init__(self, in_channels: int, b1: Sequence[int], b2: Sequence[int]):
        super().__init__()
        self.b1_0 = ConvBNRelu(in_channels, b1[0], 1)
        self.b1_1 = ConvBNRelu(b1[0], b1[1], 3, 2)
        self.b2_0 = ConvBNRelu(in_channels, b2[0], 1)
        self.b2_1 = ConvBNRelu(b2[0], b2[1], 3)
        self.b2_2 = ConvBNRelu(b2[1], b2[1], 3, 2)
        self.out_channels = b1[1] + b2[1] + in_channels

    def forward(self, x):
        return _cat(self.b1_1(self.b1_0(x)), self.b2_2(self.b2_1(self.b2_0(x))),
                    max_pool(x, 3, 2, "SAME"))


class InceptionV2(Classifier):
    """A v1-shaped stack with double-3x3 branches and a depthwise-separable
    7x7 stem (channel multiplier 8)."""

    PLAN = (
        ("Mixed_3b", dict(b0=64, b1=(64, 64), b2=(64, 96), b3=32)),
        ("Mixed_3c", dict(b0=64, b1=(64, 96), b2=(64, 96), b3=64)),
        ("Mixed_4a", dict(b1=(128, 160), b2=(64, 96))),
        ("Mixed_4b", dict(b0=224, b1=(64, 96), b2=(96, 128), b3=128)),
        ("Mixed_4c", dict(b0=192, b1=(96, 128), b2=(96, 128), b3=128)),
        ("Mixed_4d", dict(b0=160, b1=(128, 160), b2=(128, 160), b3=96)),
        ("Mixed_4e", dict(b0=96, b1=(128, 192), b2=(160, 192), b3=96)),
        ("Mixed_5a", dict(b1=(128, 192), b2=(192, 256))),
        ("Mixed_5b", dict(b0=352, b1=(192, 320), b2=(160, 224), b3=128)),
        ("Mixed_5c", dict(b0=352, b1=(192, 320), b2=(192, 224), b3=128, pool="max")),
    )

    def __init__(self, num_classes: int = 1000, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.Conv2d_1a_dw = Conv(in_channels, 8 * in_channels, 7, 2, use_bias=False,
                                 groups=in_channels)
        self.Conv2d_1a_pw = Conv(8 * in_channels, 64, 1, use_bias=False)
        self.Conv2d_1a_bn = BatchNorm(64, BN_MOMENTUM, BN_EPS)
        self.Conv2d_2b_1x1 = ConvBNRelu(64, 64, 1)
        self.Conv2d_2c_3x3 = ConvBNRelu(64, 192, 3)
        ch = 192
        for name, spec in self.PLAN:
            block = (InceptionV2Block(ch, **spec) if "b0" in spec
                     else InceptionV2Reduction(ch, **spec))
            self.add_module(name, block)
            ch = block.out_channels
        self.Logits = Dense(ch, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = F.relu(self.Conv2d_1a_bn(self.Conv2d_1a_pw(self.Conv2d_1a_dw(x))))
        x = max_pool(x, 3, 2, "SAME")
        x = max_pool(self.Conv2d_2c_3x3(self.Conv2d_2b_1x1(x)), 3, 2, "SAME")
        for name, _ in self.PLAN:
            x = _ep(eps, probes, name, getattr(self, name)(x))
        x = torch.mean(x, dim=(2, 3))
        eps["PreLogits"] = x
        logits = self.Logits(x)
        eps["Logits"] = logits
        return logits, eps


class _V4Stem(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.s0 = ConvBNRelu(in_channels, 32, 3, 2, "VALID")
        self.s1 = ConvBNRelu(32, 32, 3, padding="VALID")
        self.s2 = ConvBNRelu(32, 64, 3)
        self.s3b = ConvBNRelu(64, 96, 3, 2, "VALID")
        self.s4a0 = ConvBNRelu(160, 64, 1)
        self.s4a1 = ConvBNRelu(64, 96, 3, padding="VALID")
        self.s4b0 = ConvBNRelu(160, 64, 1)
        self.s4b1 = ConvBNRelu(64, 64, (7, 1))
        self.s4b2 = ConvBNRelu(64, 64, (1, 7))
        self.s4b3 = ConvBNRelu(64, 96, 3, padding="VALID")
        self.s5a = ConvBNRelu(192, 192, 3, 2, "VALID")
        self.out_channels = 384

    def forward(self, x):
        x = self.s2(self.s1(self.s0(x)))
        x = _cat(max_pool(x, 3, 2), self.s3b(x))
        a = self.s4a1(self.s4a0(x))
        b = self.s4b3(self.s4b2(self.s4b1(self.s4b0(x))))
        x = _cat(a, b)
        return _cat(self.s5a(x), max_pool(x, 3, 2))


class _V4BlockA(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.b0 = ConvBNRelu(in_channels, 96, 1)
        self.b1_0 = ConvBNRelu(in_channels, 64, 1)
        self.b1_1 = ConvBNRelu(64, 96, 3)
        self.b2_0 = ConvBNRelu(in_channels, 64, 1)
        self.b2_1 = ConvBNRelu(64, 96, 3)
        self.b2_2 = ConvBNRelu(96, 96, 3)
        self.b3_1 = ConvBNRelu(in_channels, 96, 1)

    def forward(self, x):
        return _cat(self.b0(x), self.b1_1(self.b1_0(x)), self.b2_2(self.b2_1(self.b2_0(x))),
                    self.b3_1(avg_pool(x)))


class _V4BlockB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.b0 = ConvBNRelu(in_channels, 384, 1)
        self.b1_0 = ConvBNRelu(in_channels, 192, 1)
        self.b1_1 = ConvBNRelu(192, 224, (1, 7))
        self.b1_2 = ConvBNRelu(224, 256, (7, 1))
        self.b2_0 = ConvBNRelu(in_channels, 192, 1)
        self.b2_1 = ConvBNRelu(192, 192, (7, 1))
        self.b2_2 = ConvBNRelu(192, 224, (1, 7))
        self.b2_3 = ConvBNRelu(224, 224, (7, 1))
        self.b2_4 = ConvBNRelu(224, 256, (1, 7))
        self.b3_1 = ConvBNRelu(in_channels, 128, 1)

    def forward(self, x):
        b1 = self.b1_2(self.b1_1(self.b1_0(x)))
        b2 = self.b2_4(self.b2_3(self.b2_2(self.b2_1(self.b2_0(x)))))
        return _cat(self.b0(x), b1, b2, self.b3_1(avg_pool(x)))


class _V4BlockC(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.b0 = ConvBNRelu(in_channels, 256, 1)
        self.b1_0 = ConvBNRelu(in_channels, 384, 1)
        self.b1_1a = ConvBNRelu(384, 256, (1, 3))
        self.b1_1b = ConvBNRelu(384, 256, (3, 1))
        self.b2_0 = ConvBNRelu(in_channels, 384, 1)
        self.b2_1 = ConvBNRelu(384, 448, (3, 1))
        self.b2_2 = ConvBNRelu(448, 512, (1, 3))
        self.b2_3a = ConvBNRelu(512, 256, (1, 3))
        self.b2_3b = ConvBNRelu(512, 256, (3, 1))
        self.b3_1 = ConvBNRelu(in_channels, 256, 1)

    def forward(self, x):
        b1 = self.b1_0(x)
        b2 = self.b2_2(self.b2_1(self.b2_0(x)))
        return _cat(self.b0(x), self.b1_1a(b1), self.b1_1b(b1), self.b2_3a(b2),
                    self.b2_3b(b2), self.b3_1(avg_pool(x)))


class InceptionV4(Classifier):
    """Stem, 4 x A, reduction A, 7 x B, reduction B, 3 x C."""

    default_image_size = 299

    def __init__(self, num_classes: int = 1000, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.Stem = _V4Stem(in_channels)
        for i in range(4):
            self.add_module(f"Mixed_5{chr(98 + i)}", _V4BlockA(384))
        self.RedA_b0 = ConvBNRelu(384, 384, 3, 2, "VALID")
        self.RedA_b1_0 = ConvBNRelu(384, 192, 1)
        self.RedA_b1_1 = ConvBNRelu(192, 224, 3)
        self.RedA_b1_2 = ConvBNRelu(224, 256, 3, 2, "VALID")
        for i in range(7):
            self.add_module(f"Mixed_6{chr(98 + i)}", _V4BlockB(1024))
        self.RedB_b0_0 = ConvBNRelu(1024, 192, 1)
        self.RedB_b0_1 = ConvBNRelu(192, 192, 3, 2, "VALID")
        self.RedB_b1_0 = ConvBNRelu(1024, 256, 1)
        self.RedB_b1_1 = ConvBNRelu(256, 256, (1, 7))
        self.RedB_b1_2 = ConvBNRelu(256, 320, (7, 1))
        self.RedB_b1_3 = ConvBNRelu(320, 320, 3, 2, "VALID")
        for i in range(3):
            self.add_module(f"Mixed_7{chr(98 + i)}", _V4BlockC(1536))
        self.Logits = Dense(1536, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = self.Stem(x)
        for i in range(4):
            x = getattr(self, f"Mixed_5{chr(98 + i)}")(x)
        eps["Mixed_5e"] = nhwc(x)
        b = self.RedA_b1_2(self.RedA_b1_1(self.RedA_b1_0(x)))
        x = _cat(self.RedA_b0(x), b, max_pool(x, 3, 2))
        for i in range(7):
            x = getattr(self, f"Mixed_6{chr(98 + i)}")(x)
        x = _ep(eps, probes, "Mixed_6h", x)
        a = self.RedB_b0_1(self.RedB_b0_0(x))
        b = self.RedB_b1_3(self.RedB_b1_2(self.RedB_b1_1(self.RedB_b1_0(x))))
        x = _cat(a, b, max_pool(x, 3, 2))
        for i in range(3):
            x = getattr(self, f"Mixed_7{chr(98 + i)}")(x)
        eps["Mixed_7d"] = nhwc(x)
        x = torch.mean(x, dim=(2, 3))
        eps["PreLogits"] = x
        logits = self.Logits(x)
        eps["Logits"] = logits
        return logits, eps


class _ResBlock35(nn.Module):
    def __init__(self, in_channels: int, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.b0 = ConvBNRelu(in_channels, 32, 1)
        self.b1_0 = ConvBNRelu(in_channels, 32, 1)
        self.b1_1 = ConvBNRelu(32, 32, 3)
        self.b2_0 = ConvBNRelu(in_channels, 32, 1)
        self.b2_1 = ConvBNRelu(32, 48, 3)
        self.b2_2 = ConvBNRelu(48, 64, 3)
        self.up = Conv(128, in_channels, 1)

    def forward(self, x):
        mixed = _cat(self.b0(x), self.b1_1(self.b1_0(x)), self.b2_2(self.b2_1(self.b2_0(x))))
        return F.relu(x + self.scale * self.up(mixed))


class _ResBlock17(nn.Module):
    def __init__(self, in_channels: int, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.b0 = ConvBNRelu(in_channels, 192, 1)
        self.b1_0 = ConvBNRelu(in_channels, 128, 1)
        self.b1_1 = ConvBNRelu(128, 160, (1, 7))
        self.b1_2 = ConvBNRelu(160, 192, (7, 1))
        self.up = Conv(384, in_channels, 1)

    def forward(self, x):
        mixed = _cat(self.b0(x), self.b1_2(self.b1_1(self.b1_0(x))))
        return F.relu(x + self.scale * self.up(mixed))


class _ResBlock8(nn.Module):
    def __init__(self, in_channels: int, scale: float = 0.20, activate: bool = True):
        super().__init__()
        self.scale, self.activate = scale, activate
        self.b0 = ConvBNRelu(in_channels, 192, 1)
        self.b1_0 = ConvBNRelu(in_channels, 192, 1)
        self.b1_1 = ConvBNRelu(192, 224, (1, 3))
        self.b1_2 = ConvBNRelu(224, 256, (3, 1))
        self.up = Conv(448, in_channels, 1)

    def forward(self, x):
        mixed = _cat(self.b0(x), self.b1_2(self.b1_1(self.b1_0(x))))
        out = x + self.scale * self.up(mixed)
        return F.relu(out) if self.activate else out


class InceptionResNetV2(Classifier):
    """Stem, 10 x block35, reduction A, 20 x block17, reduction B,
    10 x block8, a 1536-wide 1x1 conv."""

    default_image_size = 299

    def __init__(self, num_classes: int = 1000, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.Conv2d_1a = ConvBNRelu(in_channels, 32, 3, 2, "VALID")
        self.Conv2d_2a = ConvBNRelu(32, 32, 3, padding="VALID")
        self.Conv2d_2b = ConvBNRelu(32, 64, 3)
        self.Conv2d_3b = ConvBNRelu(64, 80, 1, padding="VALID")
        self.Conv2d_4a = ConvBNRelu(80, 192, 3, padding="VALID")
        self.M5b_b0 = ConvBNRelu(192, 96, 1)
        self.M5b_b1_0 = ConvBNRelu(192, 48, 1)
        self.M5b_b1_1 = ConvBNRelu(48, 64, 5)
        self.M5b_b2_0 = ConvBNRelu(192, 64, 1)
        self.M5b_b2_1 = ConvBNRelu(64, 96, 3)
        self.M5b_b2_2 = ConvBNRelu(96, 96, 3)
        self.M5b_b3_1 = ConvBNRelu(192, 64, 1)
        for i in range(10):
            self.add_module(f"block35_{i + 1}", _ResBlock35(320))
        self.RedA_b0 = ConvBNRelu(320, 384, 3, 2, "VALID")
        self.RedA_b1_0 = ConvBNRelu(320, 256, 1)
        self.RedA_b1_1 = ConvBNRelu(256, 256, 3)
        self.RedA_b1_2 = ConvBNRelu(256, 384, 3, 2, "VALID")
        for i in range(20):
            self.add_module(f"block17_{i + 1}", _ResBlock17(1088))
        self.RedB_b0_0 = ConvBNRelu(1088, 256, 1)
        self.RedB_b0_1 = ConvBNRelu(256, 384, 3, 2, "VALID")
        self.RedB_b1_0 = ConvBNRelu(1088, 256, 1)
        self.RedB_b1_1 = ConvBNRelu(256, 288, 3, 2, "VALID")
        self.RedB_b2_0 = ConvBNRelu(1088, 256, 1)
        self.RedB_b2_1 = ConvBNRelu(256, 288, 3)
        self.RedB_b2_2 = ConvBNRelu(288, 320, 3, 2, "VALID")
        for i in range(9):
            self.add_module(f"block8_{i + 1}", _ResBlock8(2080))
        self.block8_10 = _ResBlock8(2080, scale=1.0, activate=False)
        self.Conv2d_7b = ConvBNRelu(2080, 1536, 1)
        self.Logits = Dense(1536, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = self.Conv2d_2b(self.Conv2d_2a(self.Conv2d_1a(x)))
        x = max_pool(x, 3, 2)
        x = max_pool(self.Conv2d_4a(self.Conv2d_3b(x)), 3, 2)
        x = _cat(self.M5b_b0(x), self.M5b_b1_1(self.M5b_b1_0(x)),
                 self.M5b_b2_2(self.M5b_b2_1(self.M5b_b2_0(x))), self.M5b_b3_1(avg_pool(x)))
        for i in range(10):
            x = getattr(self, f"block35_{i + 1}")(x)
        x = _ep(eps, probes, "block35", x)
        b = self.RedA_b1_2(self.RedA_b1_1(self.RedA_b1_0(x)))
        x = _cat(self.RedA_b0(x), b, max_pool(x, 3, 2))
        for i in range(20):
            x = getattr(self, f"block17_{i + 1}")(x)
        eps["block17"] = nhwc(x)
        a = self.RedB_b0_1(self.RedB_b0_0(x))
        b = self.RedB_b1_1(self.RedB_b1_0(x))
        c = self.RedB_b2_2(self.RedB_b2_1(self.RedB_b2_0(x)))
        x = _cat(a, b, c, max_pool(x, 3, 2))
        for i in range(10):
            x = getattr(self, f"block8_{i + 1}")(x)
        x = self.Conv2d_7b(x)
        eps["Conv2d_7b"] = nhwc(x)
        x = torch.mean(x, dim=(2, 3))
        eps["PreLogits"] = x
        logits = self.Logits(x)
        eps["Logits"] = logits
        return logits, eps
