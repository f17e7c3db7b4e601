# Frozen copy of the parts of odam_torch/ops/sampler.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Deterministic equal-arclength angle sampling on superquadric surfaces.

Counterpart of ``odam_tpu/ops/sampler.py``: an inverse-CDF construction over
a dense theta grid, stratified latitude quantiles and a golden-ratio
longitude lattice.  Every lattice and CDF comparison runs in float32, as the
JAX package computes it (x64 off); in float64 some samples would pick a
neighbouring grid angle.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .surface import fexp, sq_surface_points

_DENSE = 512
_PHI_FRAC = float(np.float32(0.6180339887498949))   # as JAX rounds the weak constant


def linspace(start: float, stop: float, num: int, device, endpoint: bool = True
             ) -> torch.Tensor:
    """float32 linspace with JAX's formula: start*(1-s) + stop*s with
    s = i/(num-1), and the end point exactly ``stop`` (``endpoint=False``:
    s = i/num and no end point)."""
    div = num - 1 if endpoint else num
    start_t = torch.full((), start, dtype=torch.float32, device=device)
    stop_t = torch.full((), stop, dtype=torch.float32, device=device)
    step = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]]) if endpoint else out


def _superellipse_xy(theta, a1, a2, e):
    x = a1[..., None] * fexp(torch.cos(theta), e[..., None])
    y = a2[..., None] * fexp(torch.sin(theta), e[..., None])
    return torch.stack([x, y], dim=-1)


def equal_arclength_angles(a1: torch.Tensor, a2: torch.Tensor, e: torch.Tensor,
                           theta_min: float, theta_max: float, num_out: int,
                           dense: int = _DENSE) -> torch.Tensor:
    """[..., num_out] angles equally spaced in superellipse arclength."""
    dev = a1.device
    theta = linspace(theta_min, theta_max, dense, dev).expand(a1.shape + (dense,))
    pts = _superellipse_xy(theta, a1, a2, e)
    d = torch.diff(pts, dim=-2)
    seg = torch.sqrt((d * d).sum(-1))
    cdf = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, dim=-1)], dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-12)
    levels = linspace(0.0, 1.0, num_out, dev)
    idx = torch.clamp((cdf[..., None, :] <= levels[:, None]).sum(-1) - 1, 0, dense - 2)
    c0 = torch.gather(cdf, -1, idx)
    c1 = torch.gather(cdf, -1, idx + 1)
    t0 = torch.gather(theta, -1, idx)
    t1 = torch.gather(theta, -1, idx + 1)
    frac = (levels - c0) / torch.clamp(c1 - c0, min=1e-12)
    return t0 + frac * (t1 - t0)


def sample_sq_angles(scales: torch.Tensor, epsilons: torch.Tensor, n_samples: int = 1000,
                     grid: int = 201) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic (eta, omega) samples, approximately uniform on the surface.

    Args:
        scales: [..., 3]; epsilons: [..., 2] (squashed).

    Returns:
        (etas [..., S], omegas [..., S]), detached.
    """
    scales, epsilons = scales.detach(), epsilons.detach()
    dev = scales.device
    a1, a2, a3 = scales[..., 0], scales[..., 1], scales[..., 2]
    e1, e2 = epsilons[..., 0], epsilons[..., 1]
    eta_grid = equal_arclength_angles(a1, a3, e1, math.pi / 2, -math.pi / 2, grid)
    omega_grid = equal_arclength_angles(a1, a2, e2, math.pi, -math.pi, grid)

    w = 1e-3 + (a1 + a2)[..., None] * fexp(torch.cos(eta_grid), e1[..., None])
    w = torch.clamp(w, min=0.0)
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-12)

    ar = torch.arange(n_samples, dtype=torch.float32, device=dev)
    levels = (ar + 0.5) / n_samples
    idx = torch.clamp((cdf[..., None, :] < levels[:, None]).sum(-1), 0, grid - 1)
    etas = torch.gather(eta_grid, -1, idx)

    frac = torch.fmod(ar * _PHI_FRAC, 1.0)
    omega_idx = torch.clamp((frac * grid).to(torch.int64), 0, grid - 1)
    omegas = torch.gather(omega_grid, -1, omega_idx.expand(etas.shape))
    return etas, omegas


def sample_surface_points(scales: torch.Tensor, epsilons: torch.Tensor, n_samples: int = 1000,
                          grid: int = 201) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampled surface points and normals: ([..., S, 3], [..., S, 3])."""
    etas, omegas = sample_sq_angles(scales, epsilons, n_samples, grid)
    return sq_surface_points(scales, epsilons, etas, omegas)
