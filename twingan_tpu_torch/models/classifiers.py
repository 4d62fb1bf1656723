"""Classifier zoo and its factory.

Counterpart of ``twingan_tpu/models/classifiers.py``: lenet, cifarnet,
alexnet_v2, overfeat, vgg_a/16/19, illust2vec (the anime tagger, 1539-way
head, ``encode`` end point of width 1024), resnet_v1/v2 at 50 and 101
layers and resnet_v2_layernorm, mobilenet_v1; the inception family lives
in ``models/inception.py`` and NASNet in ``models/nasnet.py``, and both
register here, so every name of the JAX ``NETWORKS`` resolves.

Every network takes NHWC images and returns ``(logits, end_points)`` with
the JAX end-point names; 4-D end points are NHWC views of the NCHW
activations the modules compute with. ``probes`` adds a tensor at a named
end point, as the JAX ``_ep`` does (Grad-CAM's d(score)/d(probe) at 0);
a probe given as None is created there as a zero tensor that requires a
gradient, so one forward pass serves ``models/grad_cam.py``.

The layers are Flax's stock layers of ``models/plain_layers.py``, with
Flax's parameter names, so a Flax tree maps onto ``state_dict`` keys one
to one (``bridge.py``). ``max_pool`` pads ``SAME`` with -inf, ``avg_pool``
with zeros that count (Flax's ``count_include_pad``).

The JAX nets flatten NHWC before a dense layer (lenet, cifarnet); the port
flattens the same order. Parameter shapes that depend on the input size
(those dense layers, NASNet's auxiliary head) are fixed at construction by
``image_hw``, which is the network's ``default_image_size`` unless given.
``reset_parameters`` draws every kernel from a ``torch.Generator`` with
Flax's initializers (truncated LeCun normal, zero biases, unit scales): the
same distributions, not the same numbers.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from twingan_tpu_torch.models.plain_layers import (  # noqa: F401 (re-exported)
    BatchNorm,
    Conv,
    Dense,
    LayerNorm,
    out_size,
    pad_same,
    reset_parameters,
    same_pads,
)
from twingan_tpu_torch.ops import basic


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: str = "VALID") -> torch.Tensor:
    """Flax ``max_pool`` on NCHW: ``SAME`` pads with -inf."""
    return F.max_pool2d(pad_same(x, window, stride, padding, -math.inf), window, stride)


def avg_pool(x: torch.Tensor, window: int = 3, stride: int = 1,
             padding: str = "SAME") -> torch.Tensor:
    """Flax ``avg_pool`` on NCHW: the padded zeros count in every mean."""
    return F.avg_pool2d(pad_same(x, window, stride, padding), window, stride)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _ep(eps: Dict[str, Any], probes: Optional[dict], name: str,
        x: torch.Tensor) -> torch.Tensor:
    """Register the NCHW activation ``x`` as end point ``name`` (NHWC),
    adding the probe where one is asked for; a probe given as None becomes a
    zero tensor that requires a gradient, stored back in ``probes``."""
    if probes is not None and name in probes:
        if probes[name] is None:
            probes[name] = torch.zeros_like(nhwc(x), requires_grad=True)
        x = x + probes[name].permute(0, 3, 1, 2).to(x.dtype)
    eps[name] = nhwc(x)
    return x


class _BN(nn.Module):
    """The JAX ``_BN``: a batch norm (momentum 0.997, eps 1e-5), or a layer
    norm for ``kind="layer"``, under Flax's automatic child name."""

    def __init__(self, features: int, kind: str = "batch"):
        super().__init__()
        if kind == "layer":
            self.LayerNorm_0 = LayerNorm(features, 1e-5)
        else:
            self.BatchNorm_0 = BatchNorm(features, 0.997, 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return next(iter(self.children()))(x)


def _flat_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten NCHW in the NHWC order the JAX nets flatten in."""
    return nhwc(x).reshape(x.shape[0], -1)


class Classifier(nn.Module):
    """Base of the zoo: NHWC in, NCHW inside."""

    default_image_size = 224

    def forward(self, x: torch.Tensor, probes: Optional[dict] = None):
        return self.net(x.permute(0, 3, 1, 2), probes)


class LeNet(Classifier):
    """2 conv + pool, fc 1024, logits."""

    default_image_size = 28

    def __init__(self, num_classes: int = 10, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        hw = image_hw or self.default_image_size
        self.conv1 = Conv(in_channels, 32, 5)
        self.conv2 = Conv(32, 64, 5)
        flat = (hw // 2 // 2) ** 2 * 64
        self.fc3 = Dense(flat, 1024)
        self.fc4 = Dense(1024, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = max_pool(_ep(eps, probes, "conv1", F.relu(self.conv1(x))))
        x = max_pool(_ep(eps, probes, "conv2", F.relu(self.conv2(x))))
        x = F.relu(self.fc3(_flat_nhwc(x)))
        eps["PreLogits"] = x
        logits = self.fc4(x)
        eps["Logits"] = logits
        return logits, eps


class CifarNet(Classifier):
    """2 x (conv + pool/LRN) with ``tf.nn.lrn``'s parameters (r 4, bias 1,
    alpha 0.001/9, beta 0.75), fc 384, fc 192."""

    default_image_size = 32

    def __init__(self, num_classes: int = 10, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        hw = image_hw or self.default_image_size
        self.conv1 = Conv(in_channels, 64, 5)
        self.conv2 = Conv(64, 64, 5)
        self.fc3 = Dense((hw // 2 // 2) ** 2 * 64, 384)
        self.fc4 = Dense(384, 192)
        self.logits = Dense(192, num_classes)

    @staticmethod
    def lrn(v):
        return basic.local_response_norm(v, 4, bias=1.0, alpha=0.001 / 9.0, beta=0.75, dim=1)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = self.lrn(max_pool(F.relu(self.conv1(x))))
        x = _ep(eps, probes, "conv2", F.relu(self.conv2(x)))
        x = max_pool(self.lrn(x))
        x = F.relu(self.fc3(_flat_nhwc(x)))
        x = F.relu(self.fc4(x))
        eps["PreLogits"] = x
        logits = self.logits(x)
        eps["Logits"] = logits
        return logits, eps


def _conv_head_logits(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(2, 3))


class AlexNetV2(Classifier):
    """AlexNet v2 with the fully convolutional head (``VALID`` fc6: the
    input must be 224 px)."""

    def __init__(self, num_classes: int = 1000, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(in_channels, 64, 11, 4, "VALID")
        self.conv2 = Conv(64, 192, 5)
        self.conv3 = Conv(192, 384, 3)
        self.conv4 = Conv(384, 384, 3)
        self.conv5 = Conv(384, 256, 3)
        self.fc6 = Conv(256, 4096, 5, padding="VALID")
        self.fc7 = Conv(4096, 4096, 1)
        self.fc8 = Conv(4096, num_classes, 1)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = max_pool(F.relu(self.conv1(x)), 3, 2)
        x = max_pool(F.relu(self.conv2(x)), 3, 2)
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = _ep(eps, probes, "conv5", F.relu(self.conv5(x)))
        x = max_pool(x, 3, 2)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        logits = _conv_head_logits(self.fc8(x))
        eps["Logits"] = logits
        return logits, eps


class OverFeat(Classifier):
    """The OverFeat accurate-model stack with the fully convolutional head
    (the input must be 231 px)."""

    default_image_size = 231

    def __init__(self, num_classes: int = 1000, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(in_channels, 64, 11, 4, "VALID")
        self.conv2 = Conv(64, 256, 5, padding="VALID")
        self.conv3 = Conv(256, 512, 3)
        self.conv4 = Conv(512, 1024, 3)
        self.conv5 = Conv(1024, 1024, 3)
        self.fc6 = Conv(1024, 3072, 6, padding="VALID")
        self.fc7 = Conv(3072, 4096, 1)
        self.fc8 = Conv(4096, num_classes, 1)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = max_pool(F.relu(self.conv1(x)))
        x = max_pool(F.relu(self.conv2(x)))
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = max_pool(_ep(eps, probes, "conv5", F.relu(self.conv5(x))))
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        logits = _conv_head_logits(self.fc8(x))
        eps["Logits"] = logits
        return logits, eps


class VGG(Classifier):
    """The VGG family; ``stages`` = convs per block: vgg_a (1,1,2,2,2),
    vgg_16 (2,2,3,3,3), vgg_19 (2,2,4,4,4). ``VALID`` fc6: 224 px."""

    FILTERS = (64, 128, 256, 512, 512)

    def __init__(self, num_classes: int = 1000, stages: Sequence[int] = (2, 2, 3, 3, 3),
                 image_hw: Optional[int] = None, in_channels: int = 3):
        super().__init__()
        self.stages = tuple(stages)
        ch = in_channels
        for b, (reps, f) in enumerate(zip(self.stages, self.FILTERS), start=1):
            for r in range(1, reps + 1):
                self.add_module(f"conv{b}_{r}", Conv(ch, f, 3))
                ch = f
        self.fc6 = Conv(ch, 4096, 7, padding="VALID")
        self.fc7 = Conv(4096, 4096, 1)
        self.fc8 = Conv(4096, num_classes, 1)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        for b, reps in enumerate(self.stages, start=1):
            for r in range(1, reps + 1):
                x = F.relu(getattr(self, f"conv{b}_{r}")(x))
            x = max_pool(_ep(eps, probes, f"conv{b}", x))
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        eps["PreLogits"] = nhwc(x)
        logits = _conv_head_logits(self.fc8(x))
        eps["Logits"] = logits
        return logits, eps


class Illust2Vec(Classifier):
    """The VGG-variant anime tagger: a conv stack without the 4096 fc
    bottlenecks, a 1539-way multi-label head; the pooled pre-logits
    (``encode``, width 1024) are the distillation embedding."""

    PLAN = ((64, 1), (128, 1), (256, 2), (512, 2), (512, 2), (1024, 3))

    def __init__(self, num_classes: int = 1539, image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        ch = in_channels
        for b, (f, reps) in enumerate(self.PLAN, start=1):
            for r in range(1, reps + 1):
                self.add_module(f"conv{b}_{r}", Conv(ch, f, 3))
                ch = f
        self.logits = Dense(ch, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        for b, (_, reps) in enumerate(self.PLAN, start=1):
            for r in range(1, reps + 1):
                x = F.relu(getattr(self, f"conv{b}_{r}")(x))
            x = _ep(eps, probes, f"conv{b}", x)
            if b < len(self.PLAN):
                x = max_pool(x)
        x = _ep(eps, probes, "conv6_3", x)
        x = torch.mean(x, dim=(2, 3))
        eps["encode"] = x
        logits = self.logits(x)
        eps["Logits"] = logits
        return logits, eps


class _Bottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 preact: bool = False, norm: str = "batch"):
        super().__init__()
        f = features
        self.stride, self.preact = stride, preact
        if preact:
            self.preact_bn = _BN(in_channels, norm)
        self.conv1 = Conv(in_channels, f, 1, use_bias=False)
        self.bn1 = _BN(f, norm)
        self.conv2 = Conv(f, f, 3, stride, use_bias=False)
        self.bn2 = _BN(f, norm)
        self.conv3 = Conv(f, 4 * f, 1, use_bias=False)
        if not preact:
            self.bn3 = _BN(4 * f, norm)
        self.project = in_channels != 4 * f or stride != 1
        if self.project:
            self.shortcut = Conv(in_channels, 4 * f, 1, stride, use_bias=False)
            if not preact:
                self.shortcut_bn = _BN(4 * f, norm)

    def forward(self, x):
        shortcut = x
        if self.preact:
            x = F.relu(self.preact_bn(x))
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.conv3(y)
        if not self.preact:
            y = self.bn3(y)
        if self.project:
            shortcut = self.shortcut(x if self.preact else shortcut)
            if not self.preact:
                shortcut = self.shortcut_bn(shortcut)
        out = shortcut + y
        return out if self.preact else F.relu(out)


class ResNet(Classifier):
    """resnet_v1/v2 at 50 and 101 layers; ``norm="layer"`` is
    resnet_v2_layernorm."""

    def __init__(self, num_classes: int = 1000, blocks: Sequence[int] = (3, 4, 6, 3),
                 preact: bool = False, norm: str = "batch", image_hw: Optional[int] = None,
                 in_channels: int = 3):
        super().__init__()
        self.blocks, self.preact = tuple(blocks), preact
        self.conv1 = Conv(in_channels, 64, 7, 2, use_bias=False)
        if not preact:
            self.bn1 = _BN(64, norm)
        ch = 64
        for stage, reps in enumerate(self.blocks):
            f = 64 * 2 ** stage
            for block in range(reps):
                stride = 2 if (block == 0 and stage > 0) else 1
                self.add_module(f"block{stage + 1}_{block + 1}",
                                _Bottleneck(ch, f, stride, preact, norm))
                ch = 4 * f
        if preact:
            self.postnorm = _BN(ch, norm)
        self.logits = Dense(ch, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = self.conv1(x)
        if not self.preact:
            x = F.relu(self.bn1(x))
        x = max_pool(x, 3, 2, "SAME")
        for stage, reps in enumerate(self.blocks):
            for block in range(reps):
                x = getattr(self, f"block{stage + 1}_{block + 1}")(x)
            x = _ep(eps, probes, f"block{stage + 1}", x)
        if self.preact:
            x = F.relu(self.postnorm(x))
        x = torch.mean(x, dim=(2, 3))
        eps["PreLogits"] = x
        logits = self.logits(x)
        eps["Logits"] = logits
        return logits, eps


class MobileNetV1(Classifier):
    """The depthwise-separable stack, relu6 after each batch norm."""

    PLAN = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)) + ((512, 1),) * 5 + (
        (1024, 2), (1024, 1))

    def __init__(self, num_classes: int = 1000, depth_multiplier: float = 1.0,
                 image_hw: Optional[int] = None, in_channels: int = 3):
        super().__init__()

        def d(ch):
            return max(8, int(ch * depth_multiplier))

        self.conv0 = Conv(in_channels, d(32), 3, 2, use_bias=False)
        self.conv0_bn = _BN(d(32))
        ch = d(32)
        for i, (out, stride) in enumerate(self.PLAN, start=1):
            self.add_module(f"sep{i}_dw", Conv(ch, ch, 3, stride, use_bias=False, groups=ch))
            self.add_module(f"sep{i}_dw_bn", _BN(ch))
            self.add_module(f"sep{i}_pw", Conv(ch, d(out), 1, use_bias=False))
            self.add_module(f"sep{i}_pw_bn", _BN(d(out)))
            ch = d(out)
        self.logits = Dense(ch, num_classes)

    def net(self, x, probes):
        eps: Dict[str, Any] = {}
        x = F.relu6(self.conv0_bn(self.conv0(x)))
        for i in range(1, len(self.PLAN) + 1):
            x = F.relu6(getattr(self, f"sep{i}_dw_bn")(getattr(self, f"sep{i}_dw")(x)))
            x = F.relu6(getattr(self, f"sep{i}_pw_bn")(getattr(self, f"sep{i}_pw")(x)))
        x = _ep(eps, probes, "conv13", x)
        x = torch.mean(x, dim=(2, 3))
        eps["PreLogits"] = x
        logits = self.logits(x)
        eps["Logits"] = logits
        return logits, eps


def _inception(name):
    def build(**kw):
        from twingan_tpu_torch.models import inception

        return getattr(inception, name)(**kw)

    return build


def _nasnet(**fixed):
    def build(**kw):
        from twingan_tpu_torch.models.nasnet import NASNet

        return NASNet(**fixed, **kw)

    return build


NETWORKS: Dict[str, Callable[..., nn.Module]] = {
    "lenet": LeNet,
    "cifarnet": CifarNet,
    "alexnet_v2": AlexNetV2,
    "vgg_a": functools.partial(VGG, stages=(1, 1, 2, 2, 2)),
    "vgg_16": functools.partial(VGG, stages=(2, 2, 3, 3, 3)),
    "vgg_19": functools.partial(VGG, stages=(2, 2, 4, 4, 4)),
    "illust2vec": Illust2Vec,
    "resnet_v1_50": functools.partial(ResNet, blocks=(3, 4, 6, 3), preact=False),
    "resnet_v1_101": functools.partial(ResNet, blocks=(3, 4, 23, 3), preact=False),
    "resnet_v2_50": functools.partial(ResNet, blocks=(3, 4, 6, 3), preact=True),
    "resnet_v2_101": functools.partial(ResNet, blocks=(3, 4, 23, 3), preact=True),
    "mobilenet_v1": MobileNetV1,
    "inception_v1": _inception("InceptionV1"),
    "inception_v2": _inception("InceptionV2"),
    "inception_v3": _inception("InceptionV3"),
    "inception_v4": _inception("InceptionV4"),
    "inception_resnet_v2": _inception("InceptionResNetV2"),
    "overfeat": OverFeat,
    # Drop path: mobile trains without it (keep 1.0), large with keep 0.7.
    "nasnet_mobile": _nasnet(num_cells=12, initial_filters=44, stem_filters=32,
                             drop_path_keep_prob=1.0),
    "nasnet_large": _nasnet(num_cells=18, initial_filters=168, stem_filters=96,
                            drop_path_keep_prob=0.7),
    "resnet_v2_layernorm": functools.partial(ResNet, blocks=(3, 4, 6, 3), preact=True,
                                             norm="layer"),
}

# Every network of the JAX zoo is ported.
PLANNED = ()


def get_network_fn(name: str, num_classes: int, image_hw: Optional[int] = None,
                   **kwargs) -> nn.Module:
    """The network ``name`` with ``num_classes`` outputs, for ``image_hw``
    inputs (its default size when None), its parameters not yet drawn
    (``reset_parameters``)."""
    if name in PLANNED:
        raise NotImplementedError(
            f"{name} is registered but not yet ported; available: {sorted(NETWORKS)}")
    if name not in NETWORKS:
        raise ValueError(f"unknown network {name!r}; available: {sorted(NETWORKS)}")
    return NETWORKS[name](num_classes=num_classes, image_hw=image_hw, **kwargs)
