"""NASNet-A, mobile and large.

Counterpart of ``twingan_tpu/models/nasnet.py``: the stem, two reduction
stem cells, then three stacks of normal cells with a reduction cell between
them; separable convs (``_SepConv``: relu, depthwise, pointwise, batch norm,
twice), the relu-1x1-BN squeeze, ``_fit`` (the previous cell's output
squeezed to the current cell's size with the ceil-division stride and
``SAME`` padding, so 83 -> 42 at 331 px), the normal and reduction cells'
genotypes, the auxiliary head on the cell before the second reduction, and
drop path.

Drop path drops a whole sample's branch with probability 1 - keep and
scales the survivors by 1 / keep, in train mode when the network's keep is
below 1; keep ramps with the cell's depth and with ``progress`` (the
training step over the total: nothing is dropped at 0). Its uniform draws
come from the ``generator`` passed to the call. ``nasnet_mobile`` trains
without it (keep 1.0), ``nasnet_large`` with keep 0.7.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
    out_size,
)

BN_MOMENTUM = 0.9997
BN_EPS = 0.001


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, BN_MOMENTUM, BN_EPS)


class _SepConv(nn.Module):
    """Two separable convs with batch norm, relu before each."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        ch = in_channels
        for i in range(2):
            self.add_module(f"dw{i}", Conv(ch, ch, kernel, stride if i == 0 else 1,
                                           use_bias=False, groups=ch))
            self.add_module(f"pw{i}", Conv(ch, features, 1, use_bias=False))
            self.add_module(f"bn{i}", _bn(features))
            ch = features

    def forward(self, x):
        for i in range(2):
            x = getattr(self, f"dw{i}")(F.relu(x))
            x = getattr(self, f"bn{i}")(getattr(self, f"pw{i}")(x))
        return x


class _Squeeze(nn.Module):
    """relu, 1x1 conv, batch norm to ``features`` channels."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = Conv(in_channels, features, 1, use_bias=False)
        self.bn = _bn(features)

    def forward(self, x, stride: int = 1):
        return self.bn(self.conv(F.relu(x), stride=stride))


def _fit(squeeze: _Squeeze, prev: torch.Tensor, cur_hw: int) -> torch.Tensor:
    """``prev`` squeezed to the current cell's size: stride ceil(prev / cur)."""
    stride = -(-prev.shape[2] // cur_hw)
    return squeeze(prev, stride=max(stride, 1))


class _Cell(nn.Module):
    """The squeezes both cell kinds start with: ``sq_h`` of the current
    input, ``prev_fit0`` of the previous one."""

    def __init__(self, h_channels: int, prev_channels: int, features: int):
        super().__init__()
        self.sq_h = _Squeeze(h_channels, features)
        self.prev_fit0 = _Squeeze(prev_channels, features)

    def inputs(self, h, h_prev):
        return _fit(self.prev_fit0, h_prev, h.shape[2]), self.sq_h(h)


class _NormalCell(_Cell):
    """The NASNet-A normal cell: 6 f channels out."""

    def __init__(self, h_channels: int, prev_channels: int, features: int):
        super().__init__(h_channels, prev_channels, features)
        f = features
        self.s1a, self.s1b = _SepConv(f, f, 5), _SepConv(f, f, 3)
        self.s2a, self.s2b = _SepConv(f, f, 5), _SepConv(f, f, 3)
        self.s5a = _SepConv(f, f, 3)
        self.out_channels = 6 * f

    def forward(self, h, h_prev, dp):
        h0, h1 = self.inputs(h, h_prev)
        y1 = dp(self.s1a(h0)) + dp(self.s1b(h1))
        y2 = dp(self.s2a(h1)) + dp(self.s2b(h1))
        y3 = dp(avg_pool(h0)) + h1
        y4 = dp(avg_pool(h1)) + dp(avg_pool(h1))
        y5 = dp(self.s5a(h0)) + h0
        return torch.cat([h1, y1, y2, y3, y4, y5], dim=1)


class _ReductionCell(_Cell):
    """The NASNet-A reduction cell: stride 2, 4 f channels out."""

    def __init__(self, h_channels: int, prev_channels: int, features: int):
        super().__init__(h_channels, prev_channels, features)
        f = features
        self.r1a, self.r1b = _SepConv(f, f, 5, 2), _SepConv(f, f, 7, 2)
        self.r2b = _SepConv(f, f, 7, 2)
        self.r3b = _SepConv(f, f, 5, 2)
        self.r5a = _SepConv(f, f, 3)
        self.out_channels = 4 * f

    def forward(self, h, h_prev, dp):
        h0, h1 = self.inputs(h, h_prev)
        z1 = dp(self.r1a(h0)) + dp(self.r1b(h1))
        z2 = dp(max_pool(h0, 3, 2, "SAME")) + dp(self.r2b(h1))
        z3 = dp(avg_pool(h0, 3, 2)) + dp(self.r3b(h1))
        z4 = z2 + dp(avg_pool(z1))
        z5 = dp(self.r5a(z1)) + dp(max_pool(h0, 3, 2, "SAME"))
        return torch.cat([z2, z3, z4, z5], dim=1)


class _AuxHead(nn.Module):
    """relu, 5x5/3 average pool, bias-free 1x1 to 128, BN, relu, a conv to
    768 over the whole remaining map, BN, relu, dense."""

    def __init__(self, in_channels: int, hw: int, num_classes: int):
        super().__init__()
        pooled = out_size(hw, 5, 3, "VALID")
        self.proj = Conv(in_channels, 128, 1, use_bias=False)
        self.aux_bn0 = _bn(128)
        self.conv768 = Conv(128, 768, pooled, padding="VALID", use_bias=False)
        self.aux_bn1 = _bn(768)
        self.fc = Dense(768, num_classes)

    def forward(self, x):
        x = avg_pool(F.relu(x), 5, 3, "VALID")
        x = F.relu(self.aux_bn0(self.proj(x)))
        x = F.relu(self.aux_bn1(self.conv768(x)))
        return self.fc(x.reshape(x.shape[0], -1))


class NASNet(Classifier):
    """NASNet-A: stem, then (N normal cells + reduction) x 3."""

    def __init__(self, num_classes: int = 1000, num_cells: int = 12,
                 initial_filters: int = 44, stem_filters: int = 32,
                 drop_path_keep_prob: float = 1.0, use_aux_head: bool = True,
                 image_hw: Optional[int] = None, in_channels: int = 3):
        super().__init__()
        self.num_cells, self.drop_path_keep_prob = num_cells, drop_path_keep_prob
        hw = out_size(image_hw or self.default_image_size, 3, 2, "SAME")
        self.stem_conv = Conv(in_channels, stem_filters, 3, 2, use_bias=False)
        self.stem_bn = _bn(stem_filters)
        f = initial_filters
        prev_ch = cur_ch = stem_filters
        # (name, the cell's true number); the stem cells are numbers 0 and 1.
        self.plan: list[tuple[str, int]] = []
        for i in range(2):
            cell = _ReductionCell(cur_ch, prev_ch, f // (2 ** (2 - i)))
            self.add_module(f"stem_cell{i}", cell)
            self.plan.append((f"stem_cell{i}", i))
            prev_ch, cur_ch = cur_ch, cell.out_channels
            hw = out_size(hw, 3, 2, "SAME")
        per_stack = num_cells // 3
        cell_id = 2
        self.aux_after = None
        for stack in range(3):
            for _ in range(per_stack):
                cell = _NormalCell(cur_ch, prev_ch, f)
                self.add_module(f"cell_{cell_id}", cell)
                self.plan.append((f"cell_{cell_id}", cell_id))
                prev_ch, cur_ch = cur_ch, cell.out_channels
                cell_id += 1
            if stack == 1 and use_aux_head and num_classes and hw >= 5:
                self.aux_head = _AuxHead(cur_ch, hw, num_classes)
                self.aux_after = self.plan[-1][0]
            if stack < 2:
                f *= 2
                cell = _ReductionCell(cur_ch, prev_ch, f)
                self.add_module(f"reduction_{stack}", cell)
                self.plan.append((f"reduction_{stack}", cell_id))
                prev_ch, cur_ch = cur_ch, cell.out_channels
                cell_id += 1
                hw = out_size(hw, 3, 2, "SAME")
            self.plan.append((f"stack_{stack}", -1))
        self.Logits = Dense(cur_ch, num_classes)

    def cell_keep_prob(self, cell_idx: int, progress) -> torch.Tensor:
        """Keep probability of cell ``cell_idx`` at ``progress`` (fp32, as
        the JAX schedule computes it from a float32 progress)."""
        total = self.num_cells + 4
        kp = 1.0 - (cell_idx + 1) / total * (1.0 - self.drop_path_keep_prob)
        p = torch.clamp(torch.as_tensor(progress, dtype=torch.float32), 0.0, 1.0)
        return 1.0 - p * (1.0 - kp)

    def forward(self, x: torch.Tensor, probes: Optional[dict] = None, progress: float = 1.0,
                generator: Optional[torch.Generator] = None):
        eps: Dict[str, Any] = {}
        x = self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2)))
        use_dp = self.training and self.drop_path_keep_prob < 1.0
        if use_dp and generator is None:
            raise ValueError("NASNet with drop path in train mode needs a generator")
        prev = cur = x
        for name, cell_id in self.plan:
            if name.startswith("stack_"):
                cur = _ep(eps, probes, name, cur)
                continue
            if use_dp:
                keep = self.cell_keep_prob(cell_id, progress).to(x.device)

                def dp(v, keep=keep):
                    u = torch.rand((v.shape[0], 1, 1, 1), generator=generator,
                                   device=generator.device, dtype=v.dtype).to(v.device)
                    return v / keep * torch.floor(keep + u)
            else:
                def dp(v):
                    return v
            prev, cur = cur, getattr(self, name)(cur, prev, dp)
            if name == self.aux_after:
                eps["AuxLogits"] = self.aux_head(cur)
        cur = torch.mean(F.relu(cur), dim=(2, 3))
        eps["PreLogits"] = cur
        logits = self.Logits(cur)
        eps["Logits"] = logits
        return logits, eps
