"""Levenberg-Marquardt superquadric solver: the fast mapping path.

Counterpart of ``odam_tpu/mapping/lm_solver.py``.  Per-object damped
normal-equation steps on smoothed box-edge residuals, 20-40 iterations in
place of Adam's 200:

- the hard pixel extremes of the Adam loss are replaced by
  temperature-annealed soft extremes (a softmax over the surface samples),
  sharpened over the iterations from 2 to 50;
- each object's residual is a fixed-shape vector: its [V, 4] masked edge
  errors scaled by 1 / sqrt(valid views), 3 prior rows through the Cholesky
  factor of the prior's inverse covariance, and 3 rows anchoring the
  translation to the detector-average init (strength 0.1 x the mean
  observed box diagonal, decayed to 2% over the iterations);
- its Jacobian over the 9 packed parameters is forward-mode AD under
  ``torch.func.vmap(torch.func.jacfwd(...))`` over the objects, so no
  [O, R, O, 9] block-diagonal intermediate is built; J^T J is one batched
  [O, 9, 9] solve;
- accept/reject and the multiplicative Marquardt schedule run without
  branches, so the iterations make no host sync.

:func:`optimize_superquadrics_auto` routes objects outside the measured
envelope of the method (heavily masked edges, near-planar aspect), and
solutions whose hard-extreme residual stays high, to the Adam solve.  Its
one host read decides whether that Adam pass runs at all; it is counted in
``HOST_READS``.  The envelope and acceptance constants are the JAX
package's, measured there on the lm_envelope_sweep grid.
"""
from __future__ import annotations

import torch

from ..utils import geometry as geo
from . import optimizer as adam_opt
from . import superquadric as sq
from .optimizer import PRIOR_WEIGHT, VALID_Z, OptimizeResult

N_PARAMS = 9          # translate(3) + angle(1) + scales(3) + shapes(2)

ENVELOPE_EDGE_FRAC_MIN = 0.5
ENVELOPE_ASPECT_MIN = 0.12
ACCEPT_RESID_MAX = 0.2
LAMBDA_INIT = 1e-2    # Marquardt damping at the first iteration
TEMP_START, TEMP_END = 2.0, 50.0    # soft-extreme temperature, annealed geometrically
ANCHOR_WEIGHT = 0.1   # translation anchor, x the mean observed box diagonal

# blocking device-to-host reads made by optimize_superquadrics_auto
HOST_READS = {"fallback_any": 0}


def _pack(params: sq.SQParams) -> torch.Tensor:
    return torch.cat([params.translate, params.angle[..., None], params.scales,
                      params.shapes], dim=-1)


def _unpack(x: torch.Tensor) -> sq.SQParams:
    return sq.SQParams(translate=x[..., 0:3], angle=x[..., 3], scales=x[..., 4:7],
                       shapes=x[..., 7:9])


def _soft_extremes(params: sq.SQParams, P_cw: torch.Tensor, n_samples: int,
                   temp: torch.Tensor) -> torch.Tensor:
    """Soft pixel extremes [O, V, 4] (xmin, ymin, xmax, ymax): softmax-weighted
    over the surface samples at temperature ``temp``, samples at camera depth
    <= 0.5 left out.  As temp grows they approach the hard extremes."""
    pts = sq.surface_points_world(params, n_samples)                 # [O, S, 3]
    pix = torch.einsum("ovij,osj->ovsi", P_cw, geo.to_homogeneous(pts))
    valid = pix[..., 2] > VALID_Z
    uv = pix[..., :2] / (torch.abs(pix[..., 2:]) + 1e-6)
    x, y = uv[..., 0], uv[..., 1]

    def soft_max(v):
        w = torch.softmax(torch.where(valid, v * temp, -1e9), dim=-1)
        return (w * torch.where(valid, v, 0.0)).sum(-1)

    return torch.stack([-soft_max(-x), -soft_max(-y), soft_max(x), soft_max(y)], dim=-1)


class LMSolve:
    """One scene's LM problem: the per-object residual set-up and the
    iteration schedule of :func:`optimize_superquadrics_lm`, whose loop
    calls :meth:`step`.  ``x`` is the [O, 9] packed parameters
    (translate, angle, scales, shapes)."""

    def __init__(self, init_params: sq.SQParams, boxes: torch.Tensor, box_mask: torch.Tensor,
                 view_mask: torch.Tensor, P_cw: torch.Tensor,
                 prior_invcov: torch.Tensor | None = None, *, n_iters: int = 30,
                 n_samples: int = 512, representation: str = "super_quadric",
                 use_prior: bool = True):
        if representation not in sq.REPRESENTATIONS:
            raise ValueError(f"unknown representation {representation!r}")
        O, V, _ = boxes.shape
        dev, dt = boxes.device, boxes.dtype
        self.scales_init = init_params.scales.detach()
        eye3 = torch.eye(3, dtype=dt, device=dev)
        if use_prior:           # a missing table is a zero prior
            invcov = prior_invcov if prior_invcov is not None else torch.zeros(
                (O, 3, 3), dtype=dt, device=dev)
            self.prior_chol = torch.linalg.cholesky(PRIOR_WEIGHT * invcov + 1e-8 * eye3)
        else:
            self.prior_chol = torch.zeros((O, 3, 3), dtype=dt, device=dev)
        self.P_cw, self.boxes = P_cw, boxes
        self.active = box_mask * view_mask[..., None]                   # [O, V, 4]
        n_valid = torch.clamp(view_mask.sum(-1), min=1.0)               # [O]
        self.res_scale = 1.0 / torch.sqrt(n_valid)
        diag = torch.sqrt((boxes[..., 2] - boxes[..., 0]) ** 2
                          + (boxes[..., 3] - boxes[..., 1]) ** 2)
        diag = torch.where(torch.isnan(diag), 0.0, diag) * view_mask
        self.anchor_w = ANCHOR_WEIGHT * diag.sum(-1) / n_valid          # [O]
        self.x0 = _pack(sq.SQParams(*[t.detach() for t in init_params]))
        self.t_init = self.x0[:, 0:3]
        shapes_free = 1.0 if representation == "super_quadric" else 0.0
        self.param_free = torch.tensor([1.0] * 7 + [shapes_free] * 2, dtype=dt, device=dev)
        self.eye9 = torch.eye(N_PARAMS, dtype=dt, device=dev)
        # every iteration's temperature and anchor decay, made once in float32
        frac = torch.arange(n_iters, dtype=dt, device=dev) / max(n_iters - 1, 1)
        log_t0 = torch.log(torch.full((), TEMP_START, dtype=dt, device=dev))
        log_t1 = torch.log(torch.full((), TEMP_END, dtype=dt, device=dev))
        self.temps = torch.exp(log_t0 + (log_t1 - log_t0) * frac)
        self.anchor_decay = torch.exp(-4.0 * frac)

        def residuals_single(x_o, P_o, boxes_o, active_o, rs_o, chol_o, s_init_o, aw_o,
                             t_init_o, temp):
            p = sq.SQParams(translate=x_o[0:3][None], angle=x_o[3][None],
                            scales=x_o[4:7][None], shapes=x_o[7:9][None])
            pred = _soft_extremes(p, P_o[None], n_samples, temp)[0]    # [V, 4]
            r_edge = (pred - boxes_o) * active_o * rs_o
            r_edge = torch.where(torch.isnan(r_edge), 0.0, r_edge)
            r_prior = chol_o @ (x_o[4:7] - s_init_o)
            r_anchor = aw_o * (x_o[0:3] - t_init_o)
            r = torch.cat([r_edge.reshape(V * 4), r_prior, r_anchor])
            return r, r

        in_dims = (0,) * 9 + (None,)
        self._jac_and_res = torch.func.vmap(
            torch.func.jacfwd(residuals_single, has_aux=True), in_dims=in_dims)
        self._res = torch.func.vmap(lambda *a: residuals_single(*a)[0], in_dims=in_dims)

    def step(self, x: torch.Tensor, lam: torch.Tensor, it: int, on: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Iteration ``it`` from (x, lam): the damped Gauss-Newton step of
        every object, kept where it lowers that object's squared residual and
        ``on`` [O] holds, and lam halved there or quadrupled (in [1e-6, 1e4]).
        Returns (x, lam, the summed squared residual over ``on``)."""
        args = (self.P_cw, self.boxes, self.active, self.res_scale, self.prior_chol,
                self.scales_init, self.anchor_w * self.anchor_decay[it], self.t_init,
                self.temps[it])
        J, r = self._jac_and_res(x, *args)                              # [O, R, 9], [O, R]
        J = J * self.param_free
        g = torch.einsum("orp,or->op", J, r)
        H = torch.einsum("orp,orq->opq", J, J)
        damp = lam[:, None, None] * self.eye9 * (torch.diagonal(H, dim1=-2, dim2=-1)
                                                 + 1e-6)[:, None]
        dx = torch.linalg.solve_ex(H + damp, g[..., None])[0][..., 0] * self.param_free
        x_new = x - dx
        r_new = self._res(x_new, *args)
        cost, cost_new = (r ** 2).sum(-1), (r_new ** 2).sum(-1)
        better = cost_new < cost
        accept = better & on
        x = torch.where(accept[:, None], x_new, x)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-6, 1e4)
        return x, lam, (torch.where(accept, cost_new, cost) * on).sum()


def optimize_superquadrics_lm(
    init_params: sq.SQParams,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    view_mask: torch.Tensor,
    P_cw: torch.Tensor,
    optimize_mask: torch.Tensor,
    prior_invcov: torch.Tensor | None = None,
    *,
    n_iters: int = 30,
    n_samples: int = 512,
    representation: str = "super_quadric",
    use_prior: bool = True,
) -> OptimizeResult:
    """LM solve of all objects of a scene, with the arguments and result of
    :func:`odam_torch.mapping.optimizer.optimize_superquadrics`.
    ``loss_log`` holds each iteration's summed squared residual over the
    optimized objects (after the step's accept/reject)."""
    solve = LMSolve(init_params, boxes, box_mask, view_mask, P_cw, prior_invcov,
                    n_iters=n_iters, n_samples=n_samples, representation=representation,
                    use_prior=use_prior)
    on = optimize_mask.bool()
    x = solve.x0
    lam = torch.full((boxes.shape[0],), LAMBDA_INIT, dtype=boxes.dtype, device=boxes.device)
    losses = []
    for it in range(n_iters):
        x, lam, loss = solve.step(x, lam, it, on)
        losses.append(loss)
    loss_log = torch.stack(losses) if losses else torch.zeros(0, device=boxes.device)

    params = _unpack(x)
    with torch.no_grad():
        corners = sq.oriented_box_corners(params, max(n_samples, 512))
        corners_det = geo.box3d_corners(2.0 * solve.scales_init ** 2, init_params.angle,
                                        init_params.translate)
        corners = torch.where(on[:, None, None], corners, corners_det)
    return OptimizeResult(params=params, loss_log=loss_log, corners=corners,
                          corners_detector=corners_det)


def lm_envelope_ok(init_params: sq.SQParams, box_mask: torch.Tensor,
                   view_mask: torch.Tensor) -> torch.Tensor:
    """[O] bool: objects inside the measured envelope where LM matches Adam
    (observed edge fraction and min/max dimension ratio of the init)."""
    n_views = torch.clamp(view_mask.sum(-1), min=1.0)
    edge_frac = (box_mask * view_mask[..., None]).sum(dim=(-2, -1)) / (4.0 * n_views)
    dims = 2.0 * init_params.scales ** 2
    aspect = dims.amin(-1) / torch.clamp(dims.amax(-1), min=1e-6)
    return (edge_frac >= ENVELOPE_EDGE_FRAC_MIN) & (aspect >= ENVELOPE_ASPECT_MIN)


def normalized_fit_residual(params: sq.SQParams, boxes: torch.Tensor, box_mask: torch.Tensor,
                            view_mask: torch.Tensor, P_cw: torch.Tensor,
                            n_samples: int = 512) -> torch.Tensor:
    """[O] mean hard-extreme edge error over the active constraints, divided
    by the mean observed box diagonal (NaN-safe)."""
    pred = adam_opt.projected_extremes(params, P_cw, n_samples)
    active = box_mask * view_mask[..., None]
    err = torch.abs(pred - boxes)
    err = torch.where(torch.isnan(err) | (active == 0), 0.0, err)
    mean_err = err.sum(dim=(-2, -1)) / torch.clamp(active.sum(dim=(-2, -1)), min=1.0)
    diag = torch.sqrt((boxes[..., 2] - boxes[..., 0]) ** 2 + (boxes[..., 3] - boxes[..., 1]) ** 2)
    diag = torch.where(torch.isnan(diag), 0.0, diag) * view_mask
    mean_diag = diag.sum(-1) / torch.clamp(view_mask.sum(-1), min=1.0)
    return mean_err / torch.clamp(mean_diag, min=1e-6)


def optimize_superquadrics_auto(
    init_params: sq.SQParams,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    view_mask: torch.Tensor,
    P_cw: torch.Tensor,
    optimize_mask: torch.Tensor,
    prior_invcov: torch.Tensor | None = None,
    *,
    n_iters: int = 30,
    n_samples: int = 512,
    adam_iters: int = 200,
    adam_samples: int = 1000,
    representation: str = "super_quadric",
    use_prior: bool = True,
    accept_resid: float | None = ACCEPT_RESID_MAX,
) -> OptimizeResult:
    """LM for the objects inside its envelope, the Adam solve for the rest.

    An object falls back to Adam when it is outside ``lm_envelope_ok``
    (decided from the inputs) or when its LM solution's
    ``normalized_fit_residual`` exceeds ``accept_resid`` (None turns that
    gate off).  The fallback is one batched Adam pass over all objects,
    masked to the fallen-back ones, run only when there is one.  The result's
    ``fallback`` is that [O] mask; ``loss_log`` is the LM pass's.
    """
    ok = lm_envelope_ok(init_params, box_mask, view_mask)
    optimize_mask = optimize_mask.bool()
    res = optimize_superquadrics_lm(
        init_params, boxes, box_mask, view_mask, P_cw, optimize_mask & ok, prior_invcov,
        n_iters=n_iters, n_samples=n_samples, representation=representation,
        use_prior=use_prior)
    fallback = optimize_mask & ~ok
    if accept_resid is not None:
        resid = normalized_fit_residual(res.params, boxes, box_mask, view_mask, P_cw,
                                        n_samples=n_samples)
        fallback = fallback | (optimize_mask & ok & (resid > accept_resid))
    HOST_READS["fallback_any"] += 1
    if not bool(fallback.any()):
        return res._replace(fallback=fallback)
    res_adam = adam_opt.optimize_superquadrics(
        init_params, boxes, box_mask, view_mask, P_cw, fallback, prior_invcov,
        n_iters=adam_iters, n_samples=adam_samples, representation=representation,
        use_prior=use_prior)

    def pick(a, b):
        return torch.where(fallback.reshape(fallback.shape + (1,) * (a.ndim - 1)), a, b)

    return OptimizeResult(
        params=sq.SQParams(*[pick(a, b) for a, b in zip(res_adam.params, res.params)]),
        loss_log=res.loss_log, corners=pick(res_adam.corners, res.corners),
        corners_detector=res.corners_detector, fallback=fallback)

