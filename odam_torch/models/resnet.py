"""ResNet-50 with frozen batch norm, and the small TinyBackbone.

Counterpart of ``odam_tpu/models/resnet.py`` with the literal 7x7/s2 conv
stem (the ``s2d`` and ``im2col`` stems are TPU rewrites and wait).  Module
names follow the Flax tree so weights convert by path
(:mod:`odam_torch.models.convert`).  Convolutions run NCHW inside; the
backbones take and return NCHW, and the DETR module does the layout change.
``dtype`` is the compute dtype, with Flax's semantics (:mod:`.layers`): the
input is cast to it, convolutions and the frozen-BN affine run in it,
GroupNorm takes its statistics in float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, GroupNorm

RESNET50_STAGES = (3, 4, 6, 3)


class FrozenBatchNorm(nn.Module):
    """Affine-only batch norm with fixed statistics (eps 1e-5)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        dt = self.compute_dtype
        return x * scale.to(dt)[:, None, None] + shift.to(dt)[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False,
          dtype: torch.dtype = torch.float32) -> Conv:
    return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=bias, dtype=dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck with identity/projection shortcut."""

    def __init__(self, cin: int, mid: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        out = mid * 4
        self.conv1 = _conv(cin, mid, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(mid, dtype)
        self.conv2 = _conv(mid, mid, 3, stride, dtype=dtype)
        self.bn2 = FrozenBatchNorm(mid, dtype)
        self.conv3 = _conv(mid, out, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out, dtype)
        self.project = cin != out or stride != 1
        if self.project:
            self.downsample_conv = _conv(cin, out, 1, stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + identity)


class ResNet(nn.Module):
    """Frozen-BN ResNet; returns the requested stage outputs {stage: NCHW}."""

    def __init__(self, stage_sizes: Sequence[int] = RESNET50_STAGES,
                 return_stages: Sequence[int] = (4,), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.return_stages = tuple(return_stages)
        self.compute_dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype)
        cin, mid = 64, 64
        for stage, n_blocks in enumerate(self.stage_sizes, start=1):
            for blk in range(n_blocks):
                stride = 2 if (blk == 0 and stage > 1) else 1
                self.add_module(f"layer{stage}_{blk}", Bottleneck(cin, mid, stride, dtype))
                cin = mid * 4
            mid *= 2

    @staticmethod
    def channels(stage: int) -> int:
        return 256 * 2 ** (stage - 1)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x.to(self.compute_dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outputs = {}
        for stage, n_blocks in enumerate(self.stage_sizes, start=1):
            for blk in range(n_blocks):
                x = getattr(self, f"layer{stage}_{blk}")(x)
            if stage in self.return_stages:
                outputs[stage] = x
        return outputs


class TinyBackbone(nn.Module):
    """Small conv backbone with GroupNorm residual stages (eps 1e-6, as Flax).

    Stage s has stride 2**(s+1) (``conv1`` and each stage halve the size) and
    ``width * 2**(s-1)`` channels.
    """

    def __init__(self, width: int = 32, return_stages: Sequence[int] = (4,),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_stages = tuple(return_stages)
        self.compute_dtype = dtype
        self.conv1 = Conv(3, width, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.gn1 = GroupNorm(8, width, 1e-6, dtype)
        cin = width
        for stage in range(1, max(self.return_stages) + 1):
            ch = width * 2 ** (stage - 1)
            self.add_module(f"stage{stage}_down", _conv(cin, ch, 3, 2, dtype=dtype))
            self.add_module(f"stage{stage}_gn1", GroupNorm(8, ch, 1e-6, dtype))
            self.add_module(f"stage{stage}_conv", _conv(ch, ch, 3, dtype=dtype))
            self.add_module(f"stage{stage}_gn2", GroupNorm(8, ch, 1e-6, dtype))
            cin = ch
        self.width = width

    def channels(self, stage: int) -> int:
        return self.width * 2 ** (stage - 1)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = F.relu(self.gn1(self.conv1(x.to(self.compute_dtype))))
        outputs = {}
        for stage in range(1, max(self.return_stages) + 1):
            x = F.relu(getattr(self, f"stage{stage}_gn1")(getattr(self, f"stage{stage}_down")(x)))
            y = getattr(self, f"stage{stage}_gn2")(getattr(self, f"stage{stage}_conv")(x))
            x = F.relu(x + y)
            if stage in self.return_stages:
                outputs[stage] = x
        return outputs
