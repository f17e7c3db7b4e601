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

One iteration reads and writes fixed tensors (:class:`StaticSolve`: the
inputs, the parameters, Adam's moments, its step count as a 0-dim float32
tensor, the latest loss), so on a CUDA device it is captured once in a
CUDA graph and replayed for every iteration: the host issues one launch an
iteration instead of ~570.  The graphs are kept by what they bake in (the
device, the inputs' shapes and dtypes, the representation, whether the
prior is present, ``n_samples``, the learning rates and ``solve_step``),
the latest ``GRAPH_CACHE`` of them.  On the CPU the same iteration runs in
a Python loop.

With an ``mp`` mesh (:mod:`odam_torch.parallel.mesh`) the object axis is
sharded over the ranks, as JAX shards it (``__graft_entry__.py``'s stage
3): it is padded to a multiple of the ranks with copies of the last object,
frozen by ``optimize_mask``, each rank solves its block, and the result is
gathered on every rank (the loss log summed).  Objects are independent, so
this is the one-process solve.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..parallel import mesh as mesh_mod
from ..parallel.distributed import all_reduce_sum
from ..utils import geometry as geo
from ..utils import metrics
from . import superquadric as sq

PRIOR_WEIGHT = 20.0
VALID_Z = 0.5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# Adam iterations run by optimize_superquadrics, counted once a call; the
# CUDA graphs of an iteration captured, and the iterations replayed from one
COUNTS = {"adam_iterations": 0, "graph_captures": 0, "graph_iterations": 0}
metrics.register_counters("optim", COUNTS)

GRAPH_WARMUP = 2      # eager iterations on a side stream before a capture
GRAPH_CACHE = 4       # captured solves kept (~1.6 GiB each at 64 x 256 x 1000)
_GRAPHS: OrderedDict[tuple, "StaticSolve"] = OrderedDict()
_GRAPHS_LOCK = threading.Lock()


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
    count: int | torch.Tensor        # an int, or a 0-dim float32 tensor on the device


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
    ``prior_invcov=None`` leaves the prior out.  A tensor ``state.count``
    gives t as ``count + 1`` on the device (the same float32 value as an
    int count's) and comes back as t.  Returns (params, state, loss before
    the update)."""
    trained = _trained_leaves(representation)
    leaves = [p.detach().requires_grad_(i in trained) for i, p in enumerate(params)]
    cur = sq.SQParams(*leaves)
    with torch.enable_grad():
        per_obj = constraint_loss(cur, boxes, box_mask, view_mask, P_cw, n_samples)
        if prior_invcov is not None:
            per_obj = per_obj + PRIOR_WEIGHT * prior_loss(cur, scales_init, prior_invcov)
        loss = (per_obj * om).sum()
        grads = torch.autograd.grad(loss, [leaves[i] for i in trained])
    if isinstance(state.count, torch.Tensor):
        t = count = state.count + 1
    else:
        t, count = torch.full((), float(state.count + 1), device=boxes.device), state.count + 1
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
    return sq.SQParams(*new), AdamState(mus, nus, count), loss.detach()


class StaticSolve:
    """A solve in fixed tensors: its inputs (boxes, box_mask, view_mask,
    P_cw, om, scales_init, prior_invcov or None), the parameters, Adam's
    moments, the step count (a 0-dim float32 tensor) and the latest loss.
    :meth:`iteration` runs ``solve_step`` on them and writes its results
    back in place; ``graph`` is that iteration captured on a CUDA device."""

    def __init__(self, init_params: sq.SQParams, inputs: tuple, n_samples: int,
                 representation: str, lr_pose: float, lr_shape: float):
        self.inputs = [None if t is None else torch.empty_like(t) for t in inputs]
        self.params = sq.SQParams(*[torch.empty_like(t) for t in init_params])
        self.mu, self.nu, _ = init_adam(self.params, representation)
        dev = inputs[0].device
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        self.loss = torch.zeros((), dtype=inputs[0].dtype, device=dev)
        self.config = (n_samples, representation, lr_pose, lr_shape)
        self.trained = _trained_leaves(representation)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.load(init_params, inputs)

    def load(self, init_params: sq.SQParams, inputs: tuple) -> None:
        """Start a solve from ``init_params`` on ``inputs`` (copied in)."""
        with torch.no_grad():
            for dst, src in zip(self.inputs + list(self.params), inputs + tuple(init_params)):
                if dst is not None:
                    dst.copy_(src)
            for m in self.mu + self.nu:
                m.zero_()
            self.count.zero_()

    def iteration(self) -> None:
        """One Adam iteration from the tensors' values, written back into them."""
        params, state, loss = solve_step(self.params, AdamState(self.mu, self.nu, self.count),
                                         *self.inputs, *self.config)
        with torch.no_grad():
            for i in self.trained:
                self.params[i].copy_(params[i])
            for dst, src in zip(self.mu + self.nu, state.mu + state.nu):
                dst.copy_(src)
            self.count.copy_(state.count)
            self.loss.copy_(loss)

    def run(self, n_iters: int, loss_log: torch.Tensor) -> None:
        """``n_iters`` iterations, the loss of each into ``loss_log``: on the
        CPU one call of :meth:`iteration` each; on a CUDA device replays of
        ``graph``, captured on the first solve of more than GRAPH_WARMUP
        iterations after that many real ones run on a side stream, as
        PyTorch captures a backward pass."""
        done = 0
        if self.graph is None and self.count.is_cuda and n_iters > GRAPH_WARMUP:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for done in range(1, GRAPH_WARMUP + 1):
                    self.iteration()
                    loss_log[done - 1].copy_(self.loss)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # other threads of the process may run CUDA work meanwhile (a
            # cudaMalloc, a sync): only this thread's calls can break the capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.iteration()
            self.graph = graph
            COUNTS["graph_captures"] += 1
        for i in range(done, n_iters):
            if self.graph is None:
                self.iteration()
            else:
                self.graph.replay()
            loss_log[i].copy_(self.loss)
        if self.graph is not None:
            COUNTS["graph_iterations"] += n_iters - done


def _cached_solve(init_params: sq.SQParams, inputs: tuple, *config) -> StaticSolve:
    """The cached :class:`StaticSolve` of what its graph bakes in, loaded
    with these inputs, or a new one (the least recently used dropped past
    GRAPH_CACHE).  Call under ``_GRAPHS_LOCK``."""
    key = (inputs[0].device, config, solve_step,
           tuple(None if t is None else (t.shape, t.dtype) for t in inputs + tuple(init_params)))
    s = _GRAPHS.pop(key, None)
    if s is None:
        s = StaticSolve(init_params, inputs, *config)
    else:
        s.load(init_params, inputs)
    _GRAPHS[key] = s
    while len(_GRAPHS) > GRAPH_CACHE:
        _GRAPHS.popitem(last=False)
    return s


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
    mesh: mesh_mod.Mesh | None = None,
) -> OptimizeResult:
    """Optimize all objects of a scene jointly (over the ``mp`` axis of
    ``mesh``, when one is given: module docstring).

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
    if mesh is not None and mesh.group is not None:
        return _optimize_sharded(
            mesh, init_params, boxes, box_mask, view_mask, P_cw, optimize_mask, prior_invcov,
            n_iters=n_iters, n_samples=n_samples, representation=representation,
            use_prior=use_prior, lr_pose=lr_pose, lr_shape=lr_shape)
    COUNTS["adam_iterations"] += n_iters
    scales_init = init_params.scales.detach()
    om = optimize_mask.to(boxes.dtype)
    prior_invcov = prior_invcov if use_prior else None   # a missing table is a zero prior
    inputs = (boxes, box_mask, view_mask, P_cw, om, scales_init, prior_invcov)
    config = (n_samples, representation, lr_pose, lr_shape)
    # before the solve: box3d_corners' copy of its corner signs to the device
    # waits for the stream, so after it the host would wait for the whole solve
    with torch.no_grad():
        dims_init = 2.0 * scales_init ** 2        # invert scales = sqrt(dims / 2)
        corners_det = geo.box3d_corners(dims_init, init_params.angle, init_params.translate)
    loss_log = torch.empty(n_iters, dtype=boxes.dtype, device=boxes.device)
    if boxes.is_cuda:
        with _GRAPHS_LOCK, torch.cuda.device(boxes.device):
            s = _cached_solve(init_params, inputs, *config)
            s.run(n_iters, loss_log)
            params = sq.SQParams(*[t.clone() for t in s.params])
    else:
        s = StaticSolve(init_params, inputs, *config)
        s.run(n_iters, loss_log)
        params = s.params

    with torch.no_grad():
        corners = sq.oriented_box_corners(params, n_samples)
        corners = torch.where(optimize_mask[:, None, None], corners, corners_det)
    return OptimizeResult(params=params, loss_log=loss_log, corners=corners,
                          corners_detector=corners_det)


def _optimize_sharded(mesh: mesh_mod.Mesh, init_params: sq.SQParams, boxes, box_mask,
                      view_mask, P_cw, optimize_mask, prior_invcov, **kw) -> OptimizeResult:
    """This rank's block of the objects, padded to a multiple of the ``mp``
    ranks with copies of the last object (frozen), then gathered."""
    O = boxes.shape[0]
    k = mesh.shape["mp"]
    index = mesh_mod.pad_to_multiple(np.arange(O), k, fill=O - 1)
    real = torch.from_numpy(np.arange(len(index)) < O).to(boxes.device)
    take = torch.from_numpy(index).to(boxes.device)
    inputs = [sq.SQParams(*[t[take] for t in init_params]), boxes[take], box_mask[take],
              view_mask[take], P_cw[take], optimize_mask[take] & real,
              None if prior_invcov is None else prior_invcov[take]]
    local = optimize_superquadrics(*mesh_mod.shard_batch(inputs, mesh, "mp"), **kw)
    params, corners, corners_det = mesh_mod.gather_batch(
        (local.params, local.corners, local.corners_detector), mesh, "mp")
    return OptimizeResult(params=sq.SQParams(*[t[:O] for t in params]),
                          loss_log=all_reduce_sum(local.loss_log, mesh.group),
                          corners=corners[:O], corners_detector=corners_det[:O])
