"""Superquadric object state (the subset of ``odam_tpu/mapping/superquadric.py``
the online step's track re-projection uses)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import sampler, surface
from ..utils import geometry as geo


class SQParams(NamedTuple):
    """Batched superquadric parameters ([...] leading axes shared)."""

    translate: torch.Tensor  # [..., 3]
    angle: torch.Tensor      # [...]
    scales: torch.Tensor     # [..., 3] (sqrt of half-dimensions)
    shapes: torch.Tensor     # [..., 2] (unconstrained logits)


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
