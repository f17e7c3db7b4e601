# Frozen copy of the parts of odam_torch/utils/geometry.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Rigid transforms, rotations and box corners (counterpart of
``odam_tpu/utils/geometry.py``).  Shape-polymorphic in the leading axes."""
from __future__ import annotations

import torch

# Corner order of get_3d_box: the top face (+z) first, then the bottom face.
_CORNER_SIGNS = ((1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
                 (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1))


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last axis: [..., N, 3] -> [..., N, 4]."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


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


def corners_from_dims(dims: torch.Tensor) -> torch.Tensor:
    """8 corners of an origin-centred axis-aligned box: [..., 3] -> [..., 8, 3]."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=dims.dtype, device=dims.device)
    return signs * (dims[..., None, :] / 2.0)


def box3d_corners(dims: torch.Tensor, angle: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Oriented (yaw-only) 3D box corners: [..., 8, 3]."""
    pts = corners_from_dims(dims)
    return torch.einsum("...ij,...nj->...ni", rotz(angle), pts) + center[..., None, :]


