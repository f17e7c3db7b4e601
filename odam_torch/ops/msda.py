"""Multi-scale deformable attention (MSDA): the CUDA kernel's wrapper and its
plain version.

Deformable DETR's sampling core (Zhu et al., ICLR 2021, arXiv:2010.04159):
each query's head h takes L levels x P points at learned locations, reads
each by bilinear interpolation from that level's value map, and sums them
with softmax weights.  It replaces no TPU kernel (the JAX package runs no
deformable detector); ``odam_torch/csrc/msda.cu`` has the kernel's design
and what bounds it on the card.

Layouts: ``value`` [B, S, H, dh], the levels' pixels one after another
(level l from ``level_start[l]``, row-major over ``spatial_shapes[l]`` =
(h, w)); ``locations`` [B, Lq, H, L, P, 2], (x, y) in [0, 1] of the level;
``weights`` [B, Lq, H, L, P], already softmaxed.  The result is
[B, Lq, H, dh] in value's dtype.  A sample sits at pixel (x w - 0.5,
y h - 0.5) (``grid_sample``'s ``align_corners=False``), and a corner
outside the map reads 0.  ``spatial_shapes`` and ``level_start`` are
Python ints (they come from the feature maps' shapes), so a call reads
nothing back from the card.

Precision contract, the same on both routes: the locations and the weights
in float32 (a bfloat16 location in [0, 1] is off by up to 2^-9, 0.26 px on
a 134-wide level); the value in the compute dtype (float32 or bfloat16);
the bilinear weights, the products and the sum in float32; the output
rounded once to the value's dtype.

Routing, as :mod:`.cuda_attention`'s: with ``use_kernels`` a CUDA tensor
launches ``ms_deform_attn_kernel`` and a CPU tensor runs
:func:`ms_deform_attn_plain`; without it every call runs the plain version,
which autograd can differentiate.  The kernel has no backward, so the
kernel route raises, on any device, when grad mode is on and an input
requires grad: training builds the model with ``use_kernels=False``.

Each call runs inside the span ``odam.msda``, and is counted as kernel
``ms_deform_attn`` in group ``msda`` of :mod:`.kernels` (by the value's
dtype), with the extra ``SAMPLES``: B x Lq x H x L x P summed over every
call.  The library (:data:`.kernels.MSDA`) is built at first use with
``nvcc`` into ``odam_torch/_build/``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils import metrics
from .kernels import KERNELS

KERNEL_HEAD_DIMS = (32, 64)
KERNEL_POINTS = (1, 2, 4, 8)
MAX_LEVELS = 8


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: Sequence[tuple[int, int]],
                         level_start: Sequence[int], locations: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, as upstream's
    ``ms_deform_attn_core_pytorch``: ``grid_sample`` per level over every
    head at once, in float32."""
    B, _, H, dh = value.shape
    Lq, L, P = locations.shape[1], locations.shape[3], locations.shape[4]
    v = value.float()
    grids = 2.0 * locations.float() - 1.0
    out = None
    for lvl, ((h, w), s0) in enumerate(zip(spatial_shapes, level_start)):
        v_l = v[:, s0:s0 + h * w].permute(0, 2, 3, 1).reshape(B * H, dh, h, w)
        g_l = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Lq, P, 2)
        sampled = F.grid_sample(v_l, g_l, mode="bilinear", padding_mode="zeros",
                                align_corners=False)                       # [B H, dh, Lq, P]
        w_l = weights[:, :, :, lvl].float().transpose(1, 2).reshape(B * H, 1, Lq, P)
        part = (sampled * w_l).sum(-1)
        out = part if out is None else out + part
    return out.reshape(B, H, dh, Lq).permute(0, 3, 1, 2).to(value.dtype)


def _check(value, spatial_shapes, level_start, locations, weights) -> None:
    if value.ndim != 4 or locations.ndim != 6 or locations.shape[-1] != 2 or weights.ndim != 5:
        raise ValueError(f"expected value [B,S,H,dh], locations [B,Lq,H,L,P,2], weights "
                         f"[B,Lq,H,L,P]; got {tuple(value.shape)}, {tuple(locations.shape)}, "
                         f"{tuple(weights.shape)}")
    B, S, H, _ = value.shape
    L = locations.shape[3]
    if locations.shape[:5] != weights.shape or locations.shape[0] != B \
            or locations.shape[2] != H:
        raise ValueError(f"locations {tuple(locations.shape)} and weights "
                         f"{tuple(weights.shape)} disagree with value {tuple(value.shape)}")
    if len(spatial_shapes) != L or len(level_start) != L:
        raise ValueError(f"{len(spatial_shapes)} shapes and {len(level_start)} starts for "
                         f"{L} levels")
    end = level_start[-1] + spatial_shapes[-1][0] * spatial_shapes[-1][1]
    if any(s != sum(h * w for h, w in spatial_shapes[:i]) for i, s in enumerate(level_start)) \
            or end != S:
        raise ValueError(f"levels {tuple(spatial_shapes)} from {tuple(level_start)} do not "
                         f"tile the value's {S} rows")
    if locations.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError(f"locations and weights must be float32, got {locations.dtype}, "
                         f"{weights.dtype}")


def _launch(value, spatial_shapes, level_start, locations, weights) -> torch.Tensor:
    B, S, H, dh = value.shape
    Lq, L, P = locations.shape[1], locations.shape[3], locations.shape[4]
    if dh not in KERNEL_HEAD_DIMS or P not in KERNEL_POINTS or L > MAX_LEVELS or L * P > 32:
        raise ValueError(f"ms_deform_attn: the kernel takes dh in {KERNEL_HEAD_DIMS}, P in "
                         f"{KERNEL_POINTS} and L <= {MAX_LEVELS} with L x P <= 32; got dh {dh}, "
                         f"L {L}, P {P}")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ms_deform_attn: float32 or bfloat16 value, got {value.dtype}")
    if not (value.device == locations.device == weights.device):
        raise ValueError("ms_deform_attn: value, locations and weights on different devices")
    value, locations, weights = (x.contiguous() for x in (value, locations, weights))
    out = torch.empty((B, Lq, H, dh), dtype=value.dtype, device=value.device)
    ints = ctypes.c_int * L
    hs = ints(*(h for h, _ in spatial_shapes))
    ws = ints(*(w for _, w in spatial_shapes))
    starts = ints(*level_start)
    KERNELS["ms_deform_attn"].launch(
        value.device, value.dtype, value.data_ptr(), locations.data_ptr(), weights.data_ptr(),
        out.data_ptr(), 0 if value.dtype == torch.float32 else 1, B, S, Lq, H, dh, L, P, hs, ws,
        starts)
    return out


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[tuple[int, int]],
                   level_start: Sequence[int], locations: torch.Tensor, weights: torch.Tensor,
                   use_kernels: bool = True) -> torch.Tensor:
    """MSDA's sampling and weighted sum: [B, Lq, H, dh] (module docstring)."""
    with metrics.span("odam.msda"):
        spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        level_start = tuple(int(s) for s in level_start)
        _check(value, spatial_shapes, level_start, locations, weights)
        kernel = KERNELS["ms_deform_attn"]
        kernel.add("SAMPLES", weights.numel())
        if use_kernels and torch.is_grad_enabled() and any(
                x.requires_grad for x in (value, locations, weights)):
            raise RuntimeError(
                "the MSDA kernel has no backward: a gradient through it would be cut.  Build "
                "the model with use_kernels=False to train it, or call it under "
                "torch.no_grad()")
        if use_kernels and value.device.type == "cuda":
            return _launch(value, spatial_shapes, level_start, locations, weights)
        kernel.plain(value.dtype)
        return ms_deform_attn_plain(value, spatial_shapes, level_start, locations, weights)
