"""Dual-quadric object representation: the closed-form projected bbox.

Counterpart of ``odam_tpu/mapping/quadric.py``.  An ellipsoid is its dual
quadric Q = T diag(a1^2, a2^2, a3^2, -1) T^T; its image under a projective
camera is the dual conic C = P Q P^T, whose bounding box has a closed form.
The online step's "exact" track re-projection uses :func:`quadric_bbox`.
Everything is batched over leading axes.
"""
from __future__ import annotations

import torch

from ..utils import geometry as geo


def quadric_matrix(translate: torch.Tensor, angle: torch.Tensor,
                   scale_sq: torch.Tensor) -> torch.Tensor:
    """Dual quadric from pose and squared semi-axes: [..., 4, 4]."""
    R = geo.rotz(angle)
    top = torch.cat([R, translate[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=translate.dtype,
                          device=translate.device).expand(top[..., :1, :].shape)
    T = torch.cat([top, bottom], dim=-2)
    d = torch.cat([scale_sq, -torch.ones_like(scale_sq[..., :1])], dim=-1)
    Q0 = torch.diag_embed(d)
    return T @ Q0 @ T.transpose(-1, -2)


def conic_bbox_lines(C: torch.Tensor) -> torch.Tensor:
    """Bounding-box line offsets of a dual conic: [..., 3, 3] -> [..., 4],
    (-x_min, -y_min, -x_max, -y_max).  Discriminants are clipped at zero, so
    a degenerate conic gives finite lines."""
    c22 = C[..., 2, 2]
    bx = torch.sqrt(torch.clamp(4 * C[..., 0, 2] ** 2 - 4 * C[..., 0, 0] * c22, min=0.0))
    x0 = 0.5 / c22 * (2 * C[..., 0, 2] + bx)
    x1 = 0.5 / c22 * (2 * C[..., 0, 2] - bx)
    by = torch.sqrt(torch.clamp(4 * C[..., 1, 2] ** 2 - 4 * C[..., 1, 1] * c22, min=0.0))
    y0 = 0.5 / c22 * (2 * C[..., 1, 2] + by)
    y1 = 0.5 / c22 * (2 * C[..., 1, 2] - by)
    return torch.stack([-torch.minimum(x0, x1), -torch.minimum(y0, y1),
                        -torch.maximum(x0, x1), -torch.maximum(y0, y1)], dim=-1)


def project_quadric(Q: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Dual conic C = P Q P^T: [..., 4, 4] x [..., 3, 4] -> [..., 3, 3]."""
    return P @ Q @ P.transpose(-1, -2)


def quadric_bbox(Q: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Projected bbox [..., 4] (x_min, y_min, x_max, y_max) of a dual quadric."""
    return -conic_bbox_lines(project_quadric(Q, P))
