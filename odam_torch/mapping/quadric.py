"""Dual-quadric object representation: the closed-form projected bbox.

Counterpart of ``odam_tpu/mapping/quadric.py``.  An ellipsoid is its dual
quadric Q = T diag(a1^2, a2^2, a3^2, -1) T^T; its image under a projective
camera is the dual conic C = P Q P^T, whose bounding box has a closed form.
The online step's "exact" track re-projection uses :func:`quadric_bbox`.
:func:`fit_quadric` fits quadrics to box-line constraints with optax's Adam
step for step (:func:`plane_distance_residual` adds the optional 3D plane
term); :func:`decompose_quadric` and :func:`ellipsoid_points` read a quadric
back on the host.  The tensor functions are batched over leading axes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import geometry as geo
from .optimizer import ADAM_B1, ADAM_B2, ADAM_EPS


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


def plane_distance_residual(Q: torch.Tensor, planes: torch.Tensor,
                            plane_mask: torch.Tensor) -> torch.Tensor:
    """3D plane-tangency residual of dual quadrics [..., 4, 4] against planes
    [..., P, 4] ([normal, offset]) with ``plane_mask`` [..., P]: the offsets
    d1, d2 at which a plane of that normal touches the quadric (the roots of
    p^T Q p = 0), min(|d - d1|, |d - d2|), NaN as 0, masked mean -> [...]
    (reference sq_libs.py:170-192)."""
    n, d_gt = planes[..., :3], planes[..., 3]
    t = -Q[..., :3, 3]
    tn = 2.0 * torch.einsum("...i,...pi->...p", t, n)
    nQn = torch.einsum("...pi,...ij,...pj->...p", n, Q[..., :3, :3], n)
    B = torch.sqrt(torch.clamp(tn ** 2 + 4.0 * nQn, min=0.0))
    d1, d2 = -(tn + B) / 2.0, -(tn - B) / 2.0
    res = torch.minimum((d_gt - d1).abs(), (d_gt - d2).abs())
    res = torch.where(torch.isnan(res), 0.0, res) * plane_mask
    return res.sum(-1) / plane_mask.sum(-1).clamp(min=1.0)


def decompose_quadric(Q: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """(squared semi-axes, R, t, is_ellipsoid) of a dual quadric, on the host
    (reference sq_libs.py:257-280, with a symmetric eigendecomposition)."""
    Q = np.asarray(Q, np.float64)
    t = -Q[:3, 3:]
    A = Q[:3, :3] + t @ t.T
    w, V = np.linalg.eigh((A + A.T) / 2)
    if np.linalg.det(V) < 0:
        V = -V
    is_ellipsoid = bool((w > 0).all())
    return np.abs(w).astype(np.float32), V.astype(np.float32), t.astype(np.float32), is_ellipsoid


def ellipsoid_points(Q: np.ndarray, side: int = 50) -> tuple[np.ndarray, bool]:
    """Dense ellipsoid surface grid [side^2, 3] of a dual quadric (reference
    sq_libs.py:316-348), and whether it is an ellipsoid."""
    axes_sq, R, t, is_ellipsoid = decompose_quadric(Q)
    axes = np.sqrt(axes_sq)
    u = np.linspace(0, 2 * np.pi, side)
    v = np.linspace(0, np.pi, side)
    x = axes[0] * np.outer(np.cos(u), np.sin(v))
    y = axes[1] * np.outer(np.sin(u), np.sin(v))
    z = axes[2] * np.outer(np.ones_like(u), np.cos(v))
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3) @ R.T + t.ravel()
    return pts.astype(np.float32), is_ellipsoid


class QuadricFitResult(NamedTuple):
    translate: torch.Tensor
    angle: torch.Tensor
    scale_factor: torch.Tensor
    loss_log: torch.Tensor


def fit_quadric(init_translate: torch.Tensor, init_angle: torch.Tensor,
                half_dims: torch.Tensor, lines: torch.Tensor, line_mask: torch.Tensor,
                Ms: torch.Tensor, planes: torch.Tensor | None = None,
                plane_mask: torch.Tensor | None = None, *, n_iters: int = 500,
                lr: float = 0.01, plane_weight: float = 0.0) -> QuadricFitResult:
    """Fit dual quadrics to 2D box-line constraints (reference
    QuadricOptimizer.run, sq_libs.py:194-241): Adam on (translation, yaw, a
    global scale factor) over the masked L1 between the conic-bbox lines and
    the observed ones, plus ``plane_weight`` x the plane-tangency residual.

    Args:
        init_translate [O, 3], init_angle [O], half_dims [O, 3] (bbox / 2);
        lines [O, V, 4] observed (-x_min, -y_min, -x_max, -y_max),
        line_mask [O, V, 4], Ms [O, V, 3, 4]; optional planes [O, P, 4]
        and plane_mask [O, P].

    Returns:
        the fitted leaves and the loss before each of the n_iters updates.
    """
    params = [init_translate.detach().clone(), init_angle.detach().clone(),
              torch.ones(init_translate.shape[:-1], dtype=init_translate.dtype,
                         device=init_translate.device)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    n_valid = line_mask.sum(dim=(-2, -1)).clamp(min=1.0)
    losses = []
    for it in range(n_iters):
        leaves = [p.requires_grad_(True) for p in params]
        with torch.enable_grad():
            translate, angle, scale_factor = leaves
            Q = quadric_matrix(translate, angle, (scale_factor[..., None] * half_dims) ** 2)
            C = torch.einsum("ovij,ojk,ovlk->ovil", Ms, Q, Ms)
            l1 = (conic_bbox_lines(C) - lines).abs()
            l1 = torch.where(torch.isnan(l1), 0.0, l1) * line_mask
            loss = l1.sum() / n_valid.clamp(min=1.0).sum()
            if planes is not None and plane_weight > 0.0:
                pm = plane_mask if plane_mask is not None else torch.ones_like(planes[..., 0])
                loss = loss + plane_weight * plane_distance_residual(Q, planes, pm).mean()
            grads = torch.autograd.grad(loss, leaves)
        t = torch.full((), float(it + 1), device=loss.device)
        c1 = 1 - torch.pow(torch.full((), ADAM_B1, device=loss.device), t)
        c2 = 1 - torch.pow(torch.full((), ADAM_B2, device=loss.device), t)
        with torch.no_grad():
            for k, g in enumerate(grads):
                g = torch.where(torch.isnan(g), 0.0, g)
                mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
                nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
                params[k] = params[k].detach() + (-lr) * (
                    (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS))
        losses.append(loss.detach())
    return QuadricFitResult(*params, torch.stack(losses) if losses else torch.zeros(0))
