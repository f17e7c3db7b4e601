"""Batched multi-view superquadric optimization: the mapping solve.

Counterpart of ``odam_tpu/mapping/optimizer.py``.  All objects of a scene
are one set of [O, ...] tensors and every iteration samples, projects and
reduces for all objects and views at once:

- masked L1 between the projected surface's pixel extremes and the observed
  box edges, averaged over each object's valid views, summed over the four
  directions;
- an optional class-conditional Mahalanobis scale prior, weight 20;
- Adam, lr 0.01 on (translate, angle, scales) and 0.1 on the shape logits,
  the latter only in "super_quadric" mode (frozen otherwise).

The loop follows JAX's arithmetic where it decides the result: ``amin`` /
``amax`` and ``torch.maximum`` split the gradient among ties as
``jnp.min`` / ``jnp.maximum`` do, NaN gradients are zeroed elementwise
(not ``nan_to_num``, which would also rewrite +-inf), and Adam is written
out in optax's order of operations (``torch.optim.Adam`` rounds
differently, and 200 steps amplify that).  The iterations make no host
sync: the loss of each is kept on the device and copied once at the end.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import geometry as geo
from . import superquadric as sq

PRIOR_WEIGHT = 20.0
VALID_Z = 0.5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class OptimizeResult(NamedTuple):
    params: sq.SQParams              # final parameters [O, ...]
    loss_log: torch.Tensor           # [n_iters] total 2D loss per iteration
    corners: torch.Tensor            # [O, 8, 3] oriented boxes of the surfaces
    corners_detector: torch.Tensor   # [O, 8, 3] detector-average fallback boxes
    fallback: torch.Tensor | None = None   # [O] bool, objects the LM path left to Adam


def projected_extremes(params: sq.SQParams, P_cw: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Pixel extremes of the projected surface samples: [O, V, 4] (xmin, ymin,
    xmax, ymax).  Points at camera depth <= 0.5 are left out; pixels divide
    by |z| + 1e-6."""
    pts = sq.surface_points_world(params, n_samples)                # [O, S, 3]
    hom = geo.to_homogeneous(pts)                                   # [O, S, 4]
    O, V = P_cw.shape[:2]
    # one batched product per object: [V*3, 4] x [4, S], rows (view, xyz)
    pix = torch.matmul(P_cw.reshape(O, V * 3, 4), hom.transpose(1, 2)).reshape(O, V, 3, -1)
    z = pix[:, :, 2]                                                # [O, V, S]
    valid = z > VALID_Z
    uv = pix[:, :, :2] / (torch.abs(pix[:, :, 2:]) + 1e-6)         # [O, V, 2, S]
    big = 1e6
    x, y = uv[:, :, 0], uv[:, :, 1]
    x_min = torch.where(valid, x, big).amin(-1)
    x_max = torch.where(valid, x, -big).amax(-1)
    y_min = torch.where(valid, y, big).amin(-1)
    y_max = torch.where(valid, y, -big).amax(-1)
    return torch.stack([x_min, y_min, x_max, y_max], dim=-1)


def constraint_loss(params: sq.SQParams, boxes: torch.Tensor, box_mask: torch.Tensor,
                    view_mask: torch.Tensor, P_cw: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Per-object masked L1 box-edge loss -> [O]: the mean over valid views
    per direction, summed over the four directions."""
    pred = projected_extremes(params, P_cw, n_samples)
    l1 = torch.abs(pred - boxes)
    l1 = torch.where(torch.isnan(l1), 0.0, l1)
    l1 = l1 * box_mask * view_mask[..., None]
    n_valid = torch.clamp(view_mask.sum(-1), min=1.0)
    return l1.sum(dim=(-2, -1)) / n_valid


def prior_loss(params: sq.SQParams, scales_init: torch.Tensor,
               prior_invcov: torch.Tensor) -> torch.Tensor:
    """Class-conditional Mahalanobis scale prior -> [O]."""
    d = scales_init - params.scales
    return torch.einsum("oi,oij,oj->o", d, prior_invcov, d)


class AdamState(NamedTuple):
    """optax Adam moments of the trained leaves, and the step count."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int


def _trained_leaves(representation: str) -> tuple[int, ...]:
    """SQParams fields that Adam updates; frozen shape logits get a zero update."""
    return (0, 1, 2, 3) if representation == "super_quadric" else (0, 1, 2)


def init_adam(params: sq.SQParams, representation: str) -> AdamState:
    trained = _trained_leaves(representation)
    return AdamState(mu=[torch.zeros_like(params[i]) for i in trained],
                     nu=[torch.zeros_like(params[i]) for i in trained], count=0)


def solve_step(params: sq.SQParams, state: AdamState, boxes: torch.Tensor,
               box_mask: torch.Tensor, view_mask: torch.Tensor, P_cw: torch.Tensor,
               om: torch.Tensor, scales_init: torch.Tensor, prior_invcov: torch.Tensor | None,
               n_samples: int, representation: str, lr_pose: float = 0.01,
               lr_shape: float = 0.1) -> tuple[sq.SQParams, AdamState, torch.Tensor]:
    """One iteration: the loss at ``params``, its gradient with NaNs zeroed,
    and optax's Adam update (mu and nu in optax's order, bias corrections
    1 - b**t in float32, then ``p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)``).
    ``prior_invcov=None`` leaves the prior out.  Returns (params, state,
    loss before the update)."""
    trained = _trained_leaves(representation)
    leaves = [p.detach().requires_grad_(i in trained) for i, p in enumerate(params)]
    cur = sq.SQParams(*leaves)
    with torch.enable_grad():
        per_obj = constraint_loss(cur, boxes, box_mask, view_mask, P_cw, n_samples)
        if prior_invcov is not None:
            per_obj = per_obj + PRIOR_WEIGHT * prior_loss(cur, scales_init, prior_invcov)
        loss = (per_obj * om).sum()
        grads = torch.autograd.grad(loss, [leaves[i] for i in trained])
    t = torch.full((), float(state.count + 1), device=boxes.device)
    c1 = 1 - torch.pow(torch.full((), ADAM_B1, device=boxes.device), t)
    c2 = 1 - torch.pow(torch.full((), ADAM_B2, device=boxes.device), t)
    new = [p.detach() for p in leaves]
    mus, nus = [], []
    with torch.no_grad():
        for k, (i, g) in enumerate(zip(trained, grads)):
            g = torch.where(torch.isnan(g), 0.0, g)
            mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[k]
            lr = lr_shape if i == 3 else lr_pose
            new[i] = new[i] + (-lr) * ((mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS))
            mus.append(mu)
            nus.append(nu)
    return sq.SQParams(*new), AdamState(mus, nus, state.count + 1), loss.detach()


def optimize_superquadrics(
    init_params: sq.SQParams,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    view_mask: torch.Tensor,
    P_cw: torch.Tensor,
    optimize_mask: torch.Tensor,
    prior_invcov: torch.Tensor | None = None,
    *,
    n_iters: int = 200,
    n_samples: int = 1000,
    representation: str = "super_quadric",
    use_prior: bool = True,
    lr_pose: float = 0.01,
    lr_shape: float = 0.1,
) -> OptimizeResult:
    """Optimize all objects of a scene jointly.

    Args:
        init_params: SQParams with leading axis [O].
        boxes: [O, V, 4] observed box edges (pixels).
        box_mask: [O, V, 4] edge-constraint activity.
        view_mask: [O, V] view-slot validity.
        P_cw: [O, V, 3, 4] projections.
        optimize_mask: [O] bool; objects with too few views are frozen and
            fall back to their detector-average box.
        prior_invcov: [O, 3, 3] per-object scale-prior inverse covariance.
    """
    if representation not in sq.REPRESENTATIONS:
        raise ValueError(f"unknown representation {representation!r}")
    scales_init = init_params.scales.detach()
    om = optimize_mask.to(boxes.dtype)
    prior_invcov = prior_invcov if use_prior else None   # a missing table is a zero prior
    params = sq.SQParams(*[t.detach() for t in init_params])
    state = init_adam(params, representation)
    losses = []
    for _ in range(n_iters):
        params, state, loss = solve_step(
            params, state, boxes, box_mask, view_mask, P_cw, om, scales_init,
            prior_invcov, n_samples, representation, lr_pose, lr_shape)
        losses.append(loss)
    loss_log = torch.stack(losses) if losses else torch.zeros(0, device=boxes.device)

    with torch.no_grad():
        corners = sq.oriented_box_corners(params, n_samples)
        dims_init = 2.0 * scales_init ** 2        # invert scales = sqrt(dims / 2)
        corners_det = geo.box3d_corners(dims_init, init_params.angle, init_params.translate)
        corners = torch.where(optimize_mask[:, None, None], corners, corners_det)
    return OptimizeResult(params=params, loss_log=loss_log, corners=corners,
                          corners_detector=corners_det)
