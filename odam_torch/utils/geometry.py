"""Rigid transforms and rotations (the subset of ``odam_tpu/utils/geometry.py``
the online step uses).  Shape-polymorphic in the leading axes."""
from __future__ import annotations

import torch


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [..., 4, 4] rigid transform to [..., N, 3] points -> [..., N, 3]."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def rotz(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +z for angle [...] -> [..., 3, 3]."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 4, 4] rigid transform analytically."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, t_inv[..., None]], dim=-1)
    bottom = torch.zeros_like(T[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def camera_azimuth(T_wc: torch.Tensor) -> torch.Tensor:
    """Azimuth of the camera's optical (+z) axis in the world frame (z-up)."""
    fwd = T_wc[..., :3, 2]
    return torch.atan2(fwd[..., 1], fwd[..., 0])
