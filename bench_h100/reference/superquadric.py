# Frozen copy of the parts of odam_torch/mapping/superquadric.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Superquadric object state: a 9-DoF optimizable parameter set.

Counterpart of ``odam_tpu/mapping/superquadric.py``: translation, yaw, the
per-axis "scale roots" (the stored scale is sqrt(dims/2), squared on use)
and two unconstrained shape logits squashed into epsilon in [0.2, 1.6].
Cube mode pins the logits at -10000 (epsilon -> 0.2, near-box); quadric and
ellipsoid mode pin them at 0 (epsilon -> 0.9).  The params carry arbitrary
leading batch axes, so a scene of objects is one set of tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import sampler, surface
from . import boxes as box_ops
from . import geometry as geo

CUBE_SHAPE_LOGIT = -10000.0
ELLIPSOID_SHAPE_LOGIT = 0.0

REPRESENTATIONS = ("cube", "super_quadric", "quadric")


class SQParams(NamedTuple):
    """Batched superquadric parameters ([...] leading axes shared)."""

    translate: torch.Tensor  # [..., 3]
    angle: torch.Tensor      # [...]
    scales: torch.Tensor     # [..., 3] (sqrt of half-dimensions)
    shapes: torch.Tensor     # [..., 2] (unconstrained logits)


def init_params(translate: torch.Tensor, angle: torch.Tensor, dims: torch.Tensor,
                representation: str = "super_quadric") -> SQParams:
    """Initial parameters from detector outputs: [..., 3] centres, [...] yaw,
    [..., 3] full box dimensions (stored scale = sqrt(dims / 2))."""
    if representation not in REPRESENTATIONS:
        raise ValueError(f"unknown representation {representation!r}")
    scales = torch.sqrt(torch.clamp(dims, min=1e-4) / 2.0)
    logit = CUBE_SHAPE_LOGIT if representation == "cube" else ELLIPSOID_SHAPE_LOGIT
    shapes = torch.full(translate.shape[:-1] + (2,), logit, dtype=translate.dtype,
                        device=translate.device)
    return SQParams(translate=translate, angle=angle, scales=scales, shapes=shapes)


def effective_scales(params: SQParams) -> torch.Tensor:
    """a = scales ** 2 (the stored roots are squared on use)."""
    return params.scales ** 2


def effective_epsilons(params: SQParams) -> torch.Tensor:
    return surface.squash_shape(params.shapes)


def surface_points_world(params: SQParams, n_samples: int = 1000) -> torch.Tensor:
    """Sampled world-frame surface points: [..., S, 3]."""
    pts, _ = sampler.sample_surface_points(effective_scales(params), effective_epsilons(params),
                                           n_samples=n_samples)
    R = geo.rotz(params.angle)
    pts = torch.einsum("...ij,...sj->...si", R, pts)
    return pts + params.translate[..., None, :]


def oriented_box_corners(params: SQParams, n_samples: int = 1000) -> torch.Tensor:
    """Oriented (z-up) 3D box of each sampled surface by the min-area sweep:
    [..., 8, 3]."""
    pts = surface_points_world(params, n_samples)
    flat = pts.reshape((-1,) + pts.shape[-2:])
    return box_ops.oriented_bbox_3d_sweep(flat).reshape(pts.shape[:-2] + (8, 3))
