"""ResNet-50 with frozen batch norm, and the small TinyBackbone.

Counterpart of ``odam_tpu/models/resnet.py``.  The 7x7/s2 stem runs as the
literal conv (``stem="conv"``) or as either of JAX's rewrites of the same
math on the same ``conv1`` weight: ``"im2col"`` (patches times the
flattened kernel) and ``"s2d"`` (space-to-depth, a 4x4 stride-1 conv over
12 channels).  ``dilate_last`` swaps the last stage's stride for dilation 2
(DETR's ``dilation``).  Module names follow the Flax tree so weights convert
by path
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
          dtype: torch.dtype = torch.float32, dilation: int = 1) -> Conv:
    return Conv(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation,
                bias=bias, dtype=dtype)


def stem_im2col(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 7x7/s2 pad-3 stem as patches [B, C*49, L] times the kernel
    flattened in the same (C, KH, KW) order: NCHW in and out."""
    B, _, H, W = x.shape
    O = weight.shape[0]
    patches = F.unfold(x, 7, padding=3, stride=2)
    out = torch.einsum("ok,bkl->bol", weight.reshape(O, -1), patches)
    return out.reshape(B, O, (H - 1) // 2 + 1, (W - 1) // 2 + 1)


def stem_s2d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 7x7/s2 pad-3 stem as a 2x2 space-to-depth and a 4x4 stride-1 conv
    with padding (2, 1): output pixel p reads input rows 2p-3 .. 2p+3, and
    row u = 2m + r + 3 is phase r of s2d row p + m, so the 4-tap kernel
    holds tap (m + 2, r) = weight[2m + r + 3] (the tap m = -2, r = 0, row
    -1, never occurs and is 0).  Odd H or W is padded with a zero row or column,
    which coincides with the conv's own padding.  NCHW in and out."""
    B, C, H, W = x.shape
    x = F.pad(x, (0, W % 2, 0, H % 2))
    H2, W2 = x.shape[-2] // 2, x.shape[-1] // 2
    # [B, C, H2, 2, W2, 2] -> channels in (r, s, C) order, as JAX's
    xs = x.reshape(B, C, H2, 2, W2, 2).permute(0, 3, 5, 1, 2, 4).reshape(B, 4 * C, H2, W2)
    # with one zero row and column in front, tap (m + 2, r) is row 2(m + 2) + r
    O = weight.shape[0]
    k2 = F.pad(weight, (1, 0, 1, 0)).reshape(O, C, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), k2.reshape(O, 4 * C, 4, 4))


STEMS = {"im2col": stem_im2col, "s2d": stem_s2d}


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck with identity/projection shortcut."""

    def __init__(self, cin: int, mid: int, stride: int = 1, dtype: torch.dtype = torch.float32,
                 dilation: int = 1):
        super().__init__()
        out = mid * 4
        self.conv1 = _conv(cin, mid, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(mid, dtype)
        self.conv2 = _conv(mid, mid, 3, stride, dtype=dtype, dilation=dilation)
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
    """Frozen-BN ResNet; returns the requested stage outputs {stage: NCHW},
    running no stage past the last one requested."""

    def __init__(self, stage_sizes: Sequence[int] = RESNET50_STAGES,
                 return_stages: Sequence[int] = (4,), dtype: torch.dtype = torch.float32,
                 dilate_last: bool = False, stem: str = "conv"):
        super().__init__()
        if stem not in ("conv", *STEMS):
            raise ValueError(f"unknown stem {stem!r}")
        self.stage_sizes = tuple(stage_sizes)
        self.return_stages = tuple(return_stages)
        self.compute_dtype = dtype
        self.stem = stem
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype)
        cin, mid = 64, 64
        for stage, n_blocks in enumerate(self.stage_sizes, start=1):
            dilate = dilate_last and stage == len(self.stage_sizes)
            for blk in range(n_blocks):
                stride = 2 if (blk == 0 and stage > 1 and not dilate) else 1
                self.add_module(f"layer{stage}_{blk}",
                                Bottleneck(cin, mid, stride, dtype, 2 if dilate else 1))
                cin = mid * 4
            mid *= 2

    @staticmethod
    def channels(stage: int) -> int:
        return 256 * 2 ** (stage - 1)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = x.to(self.compute_dtype)
        if self.stem == "conv":
            x = self.conv1(x)
        else:
            x = STEMS[self.stem](x, self.conv1._compute_params()[0])
        x = F.relu(self.bn1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outputs = {}
        # stages past the last one asked for would compute nothing returned:
        # stop there, as TinyBackbone does (JAX's jit drops them unasked)
        for stage, n_blocks in enumerate(self.stage_sizes[:max(self.return_stages)], start=1):
            for blk in range(n_blocks):
                x = getattr(self, f"layer{stage}_{blk}")(x)
            if stage in self.return_stages:
                outputs[stage] = x
        return outputs


def resnet50(dtype: torch.dtype = torch.float32, dilate_last: bool = False,
             return_stages: Sequence[int] = (4,), stem: str = "conv") -> ResNet:
    return ResNet(RESNET50_STAGES, return_stages, dtype, dilate_last, stem)


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
