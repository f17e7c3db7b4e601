# Frozen copy of the parts of odam_torch/ops/surface.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Superquadric surface math (counterpart of ``odam_tpu/ops/surface.py``).

    x = a1 * f(cos eta, e1) * f(cos omega, e2)
    y = a2 * f(cos eta, e1) * f(sin omega, e2)
    z = a3 * f(sin eta, e1)

with the sign-preserving power f(x, p) = sign(x) |x|^p and the reference's
magnitude clamping.
"""
from __future__ import annotations

import torch

# A 0-dim CPU tensor joins CUDA operands as a kernel argument (no copy).
# torch.maximum splits the gradient at a tie, as jnp.maximum does;
# clamp(min=) would give all of it to |x|.
_MIN_MAG = torch.tensor(1e-6)


def fexp(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """sign(x) * max(|x|, 1e-6) ** p."""
    return torch.sign(x) * torch.pow(torch.maximum(torch.abs(x), _MIN_MAG), p)


def squash_shape(shape: torch.Tensor, min_: float = 0.2, max_: float = 1.6) -> torch.Tensor:
    """Unconstrained shape logits -> epsilon in [0.2, 1.6]."""
    return torch.sigmoid(shape) * (max_ - min_) + min_


def sq_surface_points(scales: torch.Tensor, epsilons: torch.Tensor, etas: torch.Tensor,
                      omegas: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Surface points and (unnormalized) normals: ([..., S, 3], [..., S, 3]).

    Args:
        scales: [..., 3]; epsilons: [..., 2] (squashed); etas, omegas: [..., S].
    """
    etas = torch.where(etas == 0.0, 1e-6, etas)
    omegas = torch.where(omegas == 0.0, 1e-6, omegas)
    a1, a2, a3 = scales[..., 0:1], scales[..., 1:2], scales[..., 2:3]
    e1, e2 = epsilons[..., 0:1], epsilons[..., 1:2]
    ce, se = torch.cos(etas), torch.sin(etas)
    co, so = torch.cos(omegas), torch.sin(omegas)

    x = a1 * fexp(ce, e1) * fexp(co, e2)
    y = a2 * fexp(ce, e1) * fexp(so, e2)
    z = a3 * fexp(se, e1)

    def clamp_mag(v):
        s = (v > 0).to(v.dtype) * 2.0 - 1.0
        return s * torch.maximum(torch.abs(v), _MIN_MAG)

    x, y, z = clamp_mag(x), clamp_mag(y), clamp_mag(z)
    nx = (ce ** 2) * (co ** 2) / x
    ny = (ce ** 2) * (so ** 2) / y
    nz = (se ** 2) / z
    return torch.stack([x, y, z], dim=-1), torch.stack([nx, ny, nz], dim=-1)


