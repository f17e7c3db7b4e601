"""Dry run of the port's multi-rank paths: six stages on W ranks, held to one process.

    python -m odam_torch.scripts.dryrun_distributed --world 2 --backend gloo --device cpu
    python -m odam_torch.scripts.dryrun_distributed --world 2 --backend gloo --size full

Counterpart of ``__graft_entry__.dryrun_multichip`` and
``scripts/dryrun_multiprocess.py``.  It spawns W ranks (one process each,
joined through ``init_distributed``'s explicit form on a free localhost
port), and each rank runs the six stages:

1. ``detr_train``: 3 data-parallel detector train steps on a global batch
   whose ranks hold unequal numbers of boxes (the last rank none);
2. ``detect``: the sharded ``BatchedDetector`` over a ragged last stack;
3. ``solve``: the mapping solve with the object axis over an ``mp`` mesh
   (an object count that does not divide, so one object is padding);
4. ``collectives``: ``all_gather_arrays``, ``reduce_scalars`` (mean and
   sum of rank-dependent values), ``shard_batch`` / ``gather_batch`` and
   ``shard_local_batch``;
5. ``lanes``: ``SceneParallelRunner`` with 4 lanes over the ranks and
   ragged scene lengths;
6. ``assoc_train``: 3 data-parallel associator train steps, the ranks
   holding unequal numbers of pairs.

A seventh stage, ``lane_rate``, runs only when asked for: the lanes'
aggregate frames/s over P scenes of equal length split over the ranks
(``rate`` in ``SIZES``), timed between two barriers after a warm-up run.

Each rank writes its arrays to ``rank<r>.npz`` and its timings to
``rank<r>.json`` in ``--out_dir``.  The caller runs the same stages in one
process without a group (:func:`run_stages` with ``mesh=None``) and holds
every rank to it with :func:`compare`, which raises on a mismatch; the
tests and ``chip_smoke.py`` call these functions, so the parity rules live
here.  ``--size tiny`` takes the small models of the CPU tests; ``--size
full`` the full-width ones of ``configs/detr_scan_net.yaml``, with cut
depths and shapes (``SIZES``).  The process exits 0 only if every rank
finished and every stage held.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
STAGES = ("detr_train", "detect", "solve", "collectives", "lanes", "assoc_train")
TRAIN_STEPS = 3
RANK_TIMEOUT_S = 300.0          # bounds the rendezvous and every collective of a rank

# The lane stage's tiny models and PipelineConfig (tests/test_torch_scene_parallel.py's
# seeded tiny models, greedy decode).
TINY_DETR = dict(num_classes=8, num_queries=8, hidden_dim=32, nheads=4, enc_layers=1,
                 dec_layers=1, dim_feedforward=32, aux_loss=False, backbone="tiny",
                 backbone_stage=3)
TINY_ASSOC = dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
                  self_gnn_layers=("self",), sinkhorn_iterations=20, decode="greedy")
TINY_PIPE = dict(detect_threshold=0.0, score_threshold=0.0, max_tracks=8, max_dets=5, window=6,
                 track_bbox_samples=64, max_log_frames=16, optim_iters=20, optim_samples=256,
                 min_views=4, max_objs=8, max_views=32)

SIZES = {
    "tiny": dict(
        train_detr=dict(num_classes=4, num_queries=6, hidden_dim=32, nheads=4, enc_layers=1,
                        dec_layers=2, dim_feedforward=32, backbone="tiny", backbone_stage=2,
                        aux_loss=True, dropout=0.0),
        train_image=(64, 64), train_targets=(3, (3, 2, 0, 0)),
        detect_image=(64, 64), detect_batch=4,
        solve=dict(objects=5, views=8, samples=64, iters=10, image=(128, 128)),
        lane_image=(64, 64), lane_lengths=(3, 5, 4), n_lanes=4,
        assoc=dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32),
                   gnn_layers=("self", "cross"), self_gnn_layers=("self",),
                   sinkhorn_iterations=10),
        assoc_shape=dict(T=5, W=6, N=4), assoc_pairs=(4, 3, 1, 1),
        rate=dict(lanes=4, frames=3)),
    # Full width: configs/detr_scan_net.yaml's models; cut are the depth of
    # each stage (3 train steps, 5 frames, 3-5 frames a lane), the train
    # image (256x320), the mapping capacity and iterations.
    "full": dict(
        train_image=(256, 320), train_targets=(8, (5, 3, 0, 0)),
        detect_image=(480, 640), detect_batch=4,
        solve=dict(objects=15, views=64, samples=1000, iters=20, image=(480, 640)),
        lane_image=(800, 1071), lane_lengths=(3, 5, 4), n_lanes=4,
        lane_pipe=dict(detect_threshold=0.0, score_threshold=0.0, optim_iters=40,
                       optim_samples=500, min_views=2, max_objs=16, max_views=32),
        assoc_shape=dict(T=32, W=50, N=16), assoc_pairs=(12, 9, 3, 1),
        rate=dict(lanes=8, frames=8)),
}
CONFIG = os.path.join(ROOT, "configs", "detr_scan_net.yaml")

# Tolerances of W ranks against one process (f32).  The card's local batch
# changes the cuDNN algorithm, so there the gradients are held at 1e-4 and
# the detector's float outputs at the card-vs-CPU module bar.
TOL = {
    # On the CPU the ranks and one process differ only in summation order.
    # On the card the local batch changes cuDNN's and cuBLAS's algorithms,
    # so there the first step is held at chip_smoke.py's bars for the same
    # math on other algorithms (card against CPU: loss 1e-4, gradients 1e-3;
    # the full associator's 100 Sinkhorn iterations give the widest spread).
    "loss_rtol": {"cpu": 1e-6, "cuda": 1e-4},
    "grad_of_largest": {"cpu": 1e-5, "cuda": 1e-3},
    # After the steps.  Adam normalises each element of the gradient, so an
    # element whose gradient is at rounding level moves up to lr a step
    # either way: on the card each parameter is held within 2 x steps x lr
    # of one process's and the later losses within 1e-3; the first step's
    # gradients above hold the reduce itself.
    "later_loss_rtol": {"cpu": 1e-6, "cuda": 1e-3},
    # On the CPU a later step's loss term is held relative to the larger of
    # its size now and at step 0: the ranks' f32 error is rounding of the
    # reduce, steady in absolute terms while a term shrinks.  At the tiny
    # size, 2 gloo ranks against one process: loss_offset_0 differs by
    # 2.98e-7 at 0.7678 at step 0 and by 1.79e-7 at 0.1343 at step 2 (rel
    # 1.33e-6 of the term now); the same stage run in float64 on both sides
    # differs by at most 8.7e-16 relative in every term of every step,
    # gradients by 1.7e-16 and parameters by 6.9e-17.
    "later_loss_of_step0": {"cpu": True, "cuda": False},
    "param_atol": {"cpu": 1e-5, "cuda": None},        # None: 2 x steps x lr
    "detect_atol": {"cpu": 1e-5, "cuda": 1e-3},
    "solve_rtol": 1e-4,
    "lane_rows": 1e-3,              # atol = rtol
    "lane_box_iou": 0.95,           # bboxes_qc: the Adam solve is chaotic at rounding level
    # A leaf whose one-process gradient is below this share of the global
    # norm has none but rounding noise (softmax ignores a shift common to
    # all keys, so no key bias gets one), so Adam's normalised step there is
    # noise too: such a leaf may move up to 2 x steps x lr apart.
    "noise_share": 1e-6,
}


def _pose(f: int) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    phi = 0.1 * f
    T[:3, :3] = [[np.cos(phi), 0, np.sin(phi)], [0, 1, 0], [-np.sin(phi), 0, np.cos(phi)]]
    T[:3, 3] = [0.2 * f, 0.0, -0.5]
    return T


def lane_scenes(lengths, image) -> list[dict]:
    """Seeded scenes of uint8 frames, one per length (ragged)."""
    h, w = image
    rng = np.random.default_rng(5)
    K = np.array([[100.0 * w / 64, 0, w / 2], [0, 100.0 * h / 64, h / 2], [0, 0, 1]],
                 np.float32)
    return [{"frames": [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)],
             "frame_ids": [10 * s + f for f in range(n)],
             "T_wcs": [_pose(f + 2 * s) for f in range(n)],
             "K": K * np.array([[1 + 0.1 * s], [1 + 0.1 * s], [1]], np.float32)}
            for s, n in enumerate(lengths)]


def detr_batch(size: str):
    """The global detector batch: images [B, H, W, 3] and Targets fields
    (numpy), image b holding ``n_valid[b]`` boxes."""
    S = SIZES[size]
    M, n_valid = S["train_targets"]
    B = len(n_valid)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(B, *S["train_image"], 3)).astype(np.float32)
    mask = np.zeros((B, M), bool)
    for b, n in enumerate(n_valid):
        mask[b, :n] = True
    C = _train_detr_config(size).num_classes
    targets = (rng.integers(0, C, (B, M)).astype(np.int32),
               rng.uniform(0.2, 0.6, (B, M, 4)).astype(np.float32),
               rng.uniform(0.5, 2.0, (B, M, 3)).astype(np.float32),
               rng.normal(0, 0.1, (B, M, 2)).astype(np.float32),
               rng.uniform(1.0, 4.0, (B, M)).astype(np.float32),
               rng.integers(0, 30, (B, M)).astype(np.int32), mask)
    return images, targets


def assoc_batch(size: str) -> list[np.ndarray]:
    """The global associator batch (train_associator's order of fields),
    row b holding ``pairs[b]`` valid pairs."""
    S = SIZES[size]
    T, W, N = (S["assoc_shape"][k] for k in "TWN")
    n_pairs = S["assoc_pairs"]
    B, P = len(n_pairs), max(n_pairs) + 2
    rng = np.random.default_rng(7)
    tracks = np.full((B, T, W, 79), -1.0, np.float32)
    tracks[:, :T - 2] = rng.normal(size=(B, T - 2, W, 79)).astype(np.float32)
    tm = np.zeros((B, T), bool)
    tm[:, :T - 2] = True
    dets = np.full((B, N, 79), -1.0, np.float32)
    dets[:, :N - 1] = rng.normal(size=(B, N - 1, 79)).astype(np.float32)
    dm = np.zeros((B, N), bool)
    dm[:, :N - 1] = True
    # valid tracks [0, T-2) and detections [0, N-1), or the dustbin (T, N)
    pairs = np.stack([rng.choice(np.r_[0:T - 2, T], (B, P)),
                      rng.choice(np.r_[0:N - 1, N], (B, P))], -1).astype(np.int32)
    pairs[(pairs[..., 0] == T) & (pairs[..., 1] == N)] = 0
    valid = np.zeros((B, P), bool)
    for b, n in enumerate(n_pairs):
        valid[b, :n] = True
    return [tracks, tm, dets, dm, pairs, valid]


def _train_detr_config(size: str):
    import dataclasses

    from ..models import detr as detr_mod

    if size == "tiny":
        return detr_mod.DETRConfig(**SIZES["tiny"]["train_detr"], use_kernels=False)
    return dataclasses.replace(_full_detr_config(use_kernels=False), dropout=0.0)


def _full_detr_config(use_kernels: bool = True):
    from .. import config as config_mod
    from ..models import detr as detr_mod

    return detr_mod.DETRConfig.from_cfg(config_mod.merge_cfg([CONFIG]), use_kernels=use_kernels)


def _assoc_config(size: str, **kw):
    from .. import config as config_mod
    from ..models import associator as assoc_mod

    if size == "tiny":
        return assoc_mod.AssociatorConfig(**{**SIZES["tiny"]["assoc"], **kw})
    return assoc_mod.AssociatorConfig.from_cfg(config_mod.merge_cfg([CONFIG]), **kw)


def lane_models(size: str, device):
    """(DETR, associator, PipelineConfig) of the lane and detect stages."""
    from ..models import associator as assoc_mod
    from ..models import detr as detr_mod
    from ..runtime import processor as proc_mod

    if size == "tiny":
        detr = detr_mod.build_detr(detr_mod.DETRConfig(**TINY_DETR), seed=0, device=device)
        assoc = assoc_mod.build_associator(assoc_mod.AssociatorConfig(**TINY_ASSOC), seed=1,
                                           device=device)
        return detr, assoc, proc_mod.PipelineConfig(**TINY_PIPE)
    detr = detr_mod.build_detr(_full_detr_config(), seed=0, device=device)
    assoc = assoc_mod.build_associator(_assoc_config("full"), seed=1, device=device)
    return detr, assoc, proc_mod.PipelineConfig(**SIZES["full"]["lane_pipe"])


def solve_inputs(size: str, device):
    """A synthetic mapping problem: boxes around the origin seen from a ring
    of cameras, their projected 2D boxes with pixel noise, and detector-level
    initial parameters; the last object is frozen (``optimize_mask``)."""
    from ..mapping import superquadric as sq

    S = SIZES[size]["solve"]
    O, V = S["objects"], S["views"]
    h, w = S["image"]
    rng = np.random.default_rng(3)
    centers = rng.uniform(-1.0, 1.0, (O, 3)) * [1, 1, 0.3]
    dims = rng.uniform(0.4, 1.2, (O, 3))
    yaw = rng.uniform(-np.pi, np.pi, O)
    K = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]])
    P = np.zeros((V, 3, 4))
    for v in range(V):
        a = 2 * np.pi * v / V
        cam = np.array([4.0 * np.cos(a), 4.0 * np.sin(a), 1.5])
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd], 1)
        P[v] = K @ np.concatenate([R_wc.T, -R_wc.T @ cam[:, None]], 1)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    boxes = np.zeros((O, V, 4))
    for o in range(O):
        c, s = np.cos(yaw[o]), np.sin(yaw[o])
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        corners = centers[o] + (signs * dims[o] / 2) @ R.T
        pix = np.einsum("vij,kj->vki", P, np.concatenate([corners, np.ones((8, 1))], 1))
        uv = pix[..., :2] / pix[..., 2:]
        boxes[o] = np.concatenate([uv.min(1), uv.max(1)], -1) + rng.normal(0, 2.0, (V, 4))
    view_mask = rng.random((O, V)) < 0.8
    optimize_mask = np.ones(O, bool)
    optimize_mask[-1] = False

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)

    init = sq.init_params(t(centers + rng.normal(0, 0.1, (O, 3))),
                          t(yaw + rng.normal(0, 0.1, O)), t(dims * rng.uniform(0.8, 1.2, (O, 3))))
    return (init, t(boxes), t(np.ones((O, V, 4))), t(view_mask),
            t(np.broadcast_to(P, (O, V, 3, 4))), t(optimize_mask, torch.bool)), S


def _counts() -> dict:
    """Every kernel's launches and plain calls, and the attention launches by
    batch, since the stage zeroed them (``kernels.zero_counts``)."""
    from ..ops import kernels

    return {"launches": kernels.counts("LAUNCHES"), "plain_calls": kernels.counts("PLAIN_CALLS"),
            "launches_by_batch": {k: {str(b): n for b, n in v.items()}
                                  for k, v in kernels.counts("LAUNCHES_BY_BATCH").items()}}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def flatten(obj, prefix: str = "", out: dict | None = None) -> dict[str, np.ndarray]:
    """Nested dicts, NamedTuples and lists -> arrays keyed by their
    ``/``-joined paths (a list also gives ``<path>/len``)."""
    out = {} if out is None else out
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        obj = obj._asdict()
    if isinstance(obj, dict):
        for k, v in obj.items():
            flatten(v, join(k), out)
    elif isinstance(obj, (list, tuple)):
        out[join("len")] = np.asarray(len(obj))
        for i, v in enumerate(obj):
            flatten(v, join(i), out)
    else:
        out[prefix] = np.asarray(obj)
    return out


def _trained_grads(model, state) -> dict[str, np.ndarray]:
    """The trained leaves' gradients as a flat Flax tree (Flax layouts)."""
    from ..models import convert

    trained = {id(p) for p in state.opt.parameters()}
    return flatten(convert.tensors_to_flax(model, {k: p.grad for k, p in model.named_parameters()
                                                   if id(p) in trained}))


def _params(model) -> dict[str, np.ndarray]:
    from ..models import convert

    return flatten(convert.state_dict_to_flax(model))


def _stage_detr_train(size, device, mesh, report) -> dict:
    from ..models import criterion as crit_mod
    from ..models import detr as detr_mod
    from ..models import matcher as matcher_mod
    from ..models import training as train_mod
    from ..parallel import mesh as mesh_mod

    class RecordingMatcher(matcher_mod.HungarianMatcher):
        def __call__(self, *args):
            self.last = super().__call__(*args)
            return self.last

    dcfg = _train_detr_config(size)
    model = detr_mod.build_detr(dcfg, seed=0, device=device)
    tcfg = train_mod.DetrTrainConfig(criterion=crit_mod.CriterionConfig(
        num_classes=dcfg.num_classes))
    state = train_mod.init_train_state(model, train_mod.make_detr_optimizer(model, tcfg), mesh)
    matcher = RecordingMatcher(tcfg.criterion.matcher)
    step = train_mod.make_detr_train_step(tcfg, matcher=matcher, mesh=mesh)
    images, targets = detr_batch(size)
    if mesh is not None:
        images, targets = mesh_mod.shard_batch((images, targets), mesh)
    images = torch.from_numpy(images).to(device)
    targets = crit_mod.Targets(*[torch.from_numpy(x).to(device) for x in targets])
    out, ms = {}, []
    for i in range(TRAIN_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        metrics = step(state, images, targets)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.update({f"loss/{i}/{k}": v.cpu().numpy() for k, v in metrics.items()})
        if i == 0:
            out.update({f"grad/{k}": g for k, g in _trained_grads(model, state).items()})
            out.update({f"match/{j}": m.cpu().numpy() for j, m in enumerate(matcher.last)})
    out.update({f"param/{k}": v for k, v in _params(model).items()})
    report["detr_train"] = {"step_ms": ms, "trained_leaves": len(state.opt.parameters()),
                            "trained_floats": sum(p.numel() for p in state.opt.parameters()),
                            "lr": tcfg.lr}
    if mesh is not None and mesh.group is not None:
        report["detr_train"]["allreduce_ms"] = _allreduce_ms(
            report["detr_train"]["trained_floats"] + len(metrics), device, mesh)
    return out


def _allreduce_ms(n: int, device, mesh, reps: int = 5) -> list[float]:
    """Host ms of ``reps`` all-reduces (SUM) of ``n`` float32, each ending in
    a synchronize: the gradient collective of one train step, timed alone."""
    import torch.distributed as dist

    buf = torch.ones(n, dtype=torch.float32, device=device)
    dist.all_reduce(buf, group=mesh.group)           # warm-up
    ms = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.group)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _stage_detect(size, device, mesh, report) -> dict:
    from ..ops import kernels
    from ..runtime import offline
    from ..runtime import processor as proc_mod

    detr, _, _ = lane_models(size, device)
    S = SIZES[size]
    h, w = S["detect_image"]
    B = S["detect_batch"]
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(B + 1)]
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]], np.float32)
    det = offline.BatchedDetector(detr, proc_mod.PipelineConfig(detect_threshold=0.0),
                                  batch_size=B, mesh=mesh, device=device)
    kernels.zero_counts()
    dets = det.detect_frames(frames, K, float(w), float(h))
    _sync(device)
    report["detect"] = {"frames": len(frames), "batch": B, **_counts()}
    return {name: torch.cat([getattr(d, name) for d in dets]).cpu().numpy()
            for name in dets[0]._fields}


def _stage_solve(size, device, mesh, report) -> dict:
    from ..mapping import optimizer
    from ..parallel import mesh as mesh_mod

    inputs, S = solve_inputs(size, device)
    mp = None if mesh is None else mesh_mod.make_mesh({"mp": mesh.size}, device=device)
    res = optimizer.optimize_superquadrics(*inputs, None, n_iters=S["iters"],
                                           n_samples=S["samples"], use_prior=False, mesh=mp)
    report["solve"] = {"objects": S["objects"], "views": S["views"], "iters": S["iters"]}
    out = {f"params/{k}": v.cpu().numpy() for k, v in res.params._asdict().items()}
    out.update(corners=res.corners.cpu().numpy(), loss_log=res.loss_log.cpu().numpy(),
               corners_detector=res.corners_detector.cpu().numpy())
    return out


def _stage_collectives(size, device, mesh, report) -> dict:
    from ..parallel import distributed
    from ..parallel import mesh as mesh_mod

    r = distributed.process_index()
    dp = mesh if mesh is not None else mesh_mod.make_mesh(device=device)
    x = np.arange(dp.size * 2 * 3, dtype=np.float32).reshape(dp.size * 2, 3)
    local = mesh_mod.shard_batch(x, dp)
    mesh_mod.shard_local_batch(local, dp)
    back = mesh_mod.gather_batch(torch.from_numpy(local).to(device), dp)
    values = {"loss": 1.0 + r, "acc": 2.0 * r}
    mean = distributed.reduce_scalars(values)
    total = distributed.reduce_scalars(values, average=False)
    return {"all_gather": distributed.all_gather_arrays(np.arange(3.0) + 10 * r),
            "mean": np.asarray([mean["acc"], mean["loss"]]),
            "sum": np.asarray([total["acc"], total["loss"]]),
            "local": local, "gathered": back.cpu().numpy()}


def _stage_lanes(size, device, mesh, report) -> dict:
    from ..ops import kernels
    from ..runtime import scene_parallel

    detr, assoc, cfg = lane_models(size, device)
    S = SIZES[size]
    scenes = lane_scenes(S["lane_lengths"], S["lane_image"])
    runner = scene_parallel.SceneParallelRunner(detr, assoc, cfg, S["n_lanes"], device=device,
                                                mesh=mesh)
    kernels.zero_counts()
    t0 = time.perf_counter()
    outs = runner.run_scenes(scenes, *map(float, S["lane_image"]))
    _sync(device)
    report["lanes"] = {"seconds": time.perf_counter() - t0, "n_lanes": S["n_lanes"],
                       "lanes_this_rank": runner.lanes, "scene_lengths": list(S["lane_lengths"]),
                       **_counts()}
    return flatten([{k: v for k, v in o.items() if k != "loss_log"} for o in outs])


def _stage_lane_rate(size, device, mesh, report) -> dict:
    """Aggregate lane-frames a second of ``rate["lanes"]`` scenes of
    ``rate["frames"]`` frames over the mesh's ranks: ``run_frames`` of this
    rank's lanes, after a warm-up run, between two barriers (the wall time
    of the slowest rank)."""
    from ..parallel import distributed
    from ..runtime import scene_parallel

    detr, assoc, cfg = lane_models(size, device)
    S = SIZES[size]
    P, F = S["rate"]["lanes"], S["rate"]["frames"]
    scenes = lane_scenes((F,) * P, S["lane_image"])
    runner = scene_parallel.SceneParallelRunner(detr, assoc, cfg, P, device=device, mesh=mesh)
    index = 0 if mesh is None else mesh.index("dp")
    mine = [] if index is None else scenes[index * runner.lanes:(index + 1) * runner.lanes]
    img = tuple(map(float, S["lane_image"]))
    seconds = []
    for _ in range(2):                      # warm-up, then timed
        distributed.barrier()
        t0 = time.perf_counter()
        if mine:
            runner.run_frames(mine, *img)
        _sync(device)
        distributed.barrier()
        seconds.append(time.perf_counter() - t0)
    report["lane_rate"] = {"lanes": P, "lanes_this_rank": runner.lanes, "frames_per_lane": F,
                           "seconds": seconds[-1], "warmup_seconds": seconds[0],
                           "aggregate_frames_per_s": P * F / seconds[-1]}
    return {}


def _stage_assoc_train(size, device, mesh, report) -> dict:
    from ..models import associator as assoc_mod
    from ..models import training as train_mod
    from ..parallel import mesh as mesh_mod

    model = assoc_mod.build_associator(_assoc_config(size, use_kernels=False), seed=2,
                                       device=device)
    state = train_mod.init_train_state(
        model, train_mod.make_assoc_optimizer(model, train_mod.AssocTrainConfig()), mesh)
    step = train_mod.make_assoc_train_step(mesh)
    batch = assoc_batch(size)
    if mesh is not None:
        batch = mesh_mod.shard_batch(batch, mesh)
    batch = [torch.from_numpy(x).to(device) for x in batch]
    out, ms = {}, []
    for i in range(TRAIN_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        loss = step(state, *batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        out[f"loss/{i}"] = loss.cpu().numpy()
        if i == 0:
            out.update({f"grad/{k}": g for k, g in _trained_grads(model, state).items()})
    out.update({f"param/{k}": v for k, v in _params(model).items()})
    report["assoc_train"] = {"step_ms": ms, "lr": train_mod.AssocTrainConfig().lr}
    return out


def run_stages(size: str = "tiny", device=None, mesh=None,
               stages: tuple[str, ...] = STAGES) -> tuple[dict, dict]:
    """Run ``stages`` on this rank (``mesh``: the ``dp`` mesh over every
    rank; None: one process), on ``device`` (default: the card; it raises
    without one).  Returns (arrays keyed ``stage/name``, a report with each
    stage's seconds, peak memory on the card, launches and timings)."""
    from .. import resolve_device

    fns = {"detr_train": _stage_detr_train, "detect": _stage_detect, "solve": _stage_solve,
           "collectives": _stage_collectives, "lanes": _stage_lanes,
           "assoc_train": _stage_assoc_train, "lane_rate": _stage_lane_rate}
    dev = resolve_device(device)
    arrays, report = {}, {"size": size, "device": str(dev), "seconds": {}, "peak_bytes": {}}
    for name in stages:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        arrays.update({f"{name}/{k}": v for k, v in fns[name](size, dev, mesh, report).items()})
        _sync(dev)
        report["seconds"][name] = time.perf_counter() - t0
        if dev.type == "cuda":
            report["peak_bytes"][name] = torch.cuda.max_memory_allocated()
    return arrays, report


# ------------------------------------------------------------------ spawn

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(world: int, backend: str, device: str, size: str, out_dir: str,
          stages: tuple[str, ...] = STAGES, threads: int | None = None) -> list:
    """Spawn ``world`` ranks (returns their ``Popen`` handles; see
    :func:`wait`).  ``threads``: torch's intra-op threads a rank."""
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    for r in range(world):
        argv = [sys.executable, "-m", "odam_torch.scripts.dryrun_distributed", "--rank", str(r),
                "--world", str(world), "--port", str(port), "--backend", backend,
                "--device", device, "--size", size, "--out_dir", out_dir,
                "--stages", ",".join(stages)]
        if threads:
            argv += ["--threads", str(threads)]
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def wait(procs: list, out_dir: str, timeout_s: float) -> list[tuple[dict, dict]]:
    """Wait for every rank (killing all at ``timeout_s``); raises unless
    each exited 0.  Returns each rank's (arrays, report)."""
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"ranks still running after {timeout_s} s: "
                           + _logs(out_dir, len(procs))) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.returncode for p in procs]}: "
                           + _logs(out_dir, len(procs)))
    results = []
    for r in range(len(procs)):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append((arrays, json.load(f)))
    return results


def _logs(out_dir: str, world: int) -> str:
    text = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.log")
        if os.path.exists(path):
            with open(path) as f:
                text.append(f"--- rank {r}\n{f.read()[-4000:]}")
    return "\n".join(text)


def rank_main(args) -> int:
    from ..parallel import distributed
    from ..parallel import mesh as mesh_mod

    if args.threads:
        torch.set_num_threads(args.threads)
    device = distributed.init_distributed(f"tcp://localhost:{args.port}", args.world, args.rank,
                                          args.backend, args.device, timeout_s=RANK_TIMEOUT_S)
    try:
        if args.device == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        mesh = mesh_mod.make_mesh(device=device)
        arrays, report = run_stages(args.size, device, mesh, tuple(args.stages.split(",")))
        report.update(rank=args.rank, world=args.world, backend=args.backend)
        np.savez(os.path.join(args.out_dir, f"rank{args.rank}.npz"), **arrays)
        with open(os.path.join(args.out_dir, f"rank{args.rank}.json"), "w") as f:
            json.dump(report, f)
        distributed.barrier()
    finally:
        distributed.destroy()
    return 0


# --------------------------------------------------------------- compare

def _close(where: str, got, want, atol: float, rtol: float = 0.0) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{where}: shape {got.shape} against {want.shape}")
    err = float(np.abs(got - want).max(initial=0.0))
    if not np.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{where}: max |diff| {err:.3e} (atol {atol}, rtol {rtol})")
    return err


def _exact(where: str, got, want) -> None:
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise AssertionError(f"{where}: not equal")


def _train_parity(stage: str, ref: dict, got: dict, kind: str, lr: float) -> dict:
    """Losses, first-step gradients and parameters after the steps: every
    error is measured, then any over its bar raises with all of them."""
    grads = {k[5:]: v for k, v in ref.items() if k.startswith("grad/")}
    norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for g in grads.values()))
    noise = {k for k, g in grads.items() if np.linalg.norm(g) <= TOL["noise_share"] * norm}
    largest = max(float(np.abs(g).max(initial=0.0)) for g in grads.values())
    if set(got) - set(ref):
        raise AssertionError(f"{stage}: keys {sorted(set(got) - set(ref))[:4]} not in one process")
    rep = {"loss_rel_by_step": [0.0] * TRAIN_STEPS, "grad_max_abs": 0.0,
           "largest_grad": largest, "param_max_abs": 0.0, "noise_leaves": len(noise),
           "noise_param_max_abs": 0.0}
    over = []
    for k, want in ref.items():
        if k.startswith("match/"):
            continue                        # held per rank by the caller
        err = float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want, np.float64)).max(
            initial=0.0))
        if k.startswith("loss/"):
            _, step, *term = k.split("/", 2)
            i = int(step)
            scale = abs(float(want))
            if i > 0 and TOL["later_loss_of_step0"][kind]:
                scale = max(scale, abs(float(ref["/".join(["loss", "0", *term])])))
            rel = err / max(scale, 1e-30)
            rep["loss_rel_by_step"][i] = max(rep["loss_rel_by_step"][i], rel)
            bar = TOL["loss_rtol" if i == 0 else "later_loss_rtol"][kind]
            if rel > bar:
                over.append(f"{k} rel {rel:.3e} > {bar}")
        elif k.startswith("grad/"):
            rep["grad_max_abs"] = max(rep["grad_max_abs"], err)
            if err > TOL["grad_of_largest"][kind] * largest:
                over.append(f"{k} {err:.3e} > {TOL['grad_of_largest'][kind]} x {largest:.3e}")
        elif k.startswith("param/"):
            adam = 2 * TRAIN_STEPS * lr
            noisy = k[6:] in noise
            rep["noise_param_max_abs" if noisy else "param_max_abs"] = max(
                rep["noise_param_max_abs" if noisy else "param_max_abs"], err)
            bar = adam if noisy or TOL["param_atol"][kind] is None else TOL["param_atol"][kind]
            if err > bar:
                over.append(f"{k} {err:.3e} > {bar}")
    if over:
        raise AssertionError(f"{stage}: {len(over)} over their bars: {over[:6]}; {rep}")
    return rep


def _stage(arrays: dict, stage: str) -> dict:
    n = len(stage) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(stage + "/")}


def compare(reference: tuple[dict, dict], ranks: list[tuple[dict, dict]]) -> dict:
    """Hold every rank's stages to the one-process ``reference`` (both as
    :func:`run_stages` returns them), by the rules of ``TOL``; raises
    AssertionError at the first mismatch.  Returns the worst errors."""
    ref, ref_report = reference
    kind = "cuda" if ref_report["device"].startswith("cuda") else "cpu"
    world = len(ranks)
    stages = [s for s in STAGES if any(k.startswith(s + "/") for k in ranks[0][0])]
    out = {"world": world, "device": kind, "stages": stages}
    failures = []
    for r, (arrays, report) in enumerate(ranks):
        rep = out.setdefault(f"rank{r}", {})
        for stage in stages:
            try:
                _compare_stage(stage, r, world, kind, arrays, report, ref, ref_report, rep)
            except AssertionError as e:
                failures.append(f"rank {r} {e}")
    if failures:
        raise AssertionError(f"{len(failures)} stage(s) failed:\n" + "\n".join(failures))
    return out


def _compare_stage(stage, r, world, kind, arrays, report, ref, ref_report, rep) -> None:
    """One stage of rank ``r`` against one process (see :func:`compare`)."""
    if stage == "detr_train":
        got, want = _stage(arrays, "detr_train"), _stage(ref, "detr_train")
        rep["detr_train"] = _train_parity("detr_train", want, got, kind,
                                          report["detr_train"]["lr"])
        # each rank's matches are those of its rows of the global batch
        for k in [k for k in want if k.startswith("match/")]:
            B = want[k].shape[0]
            _exact(f"detr_train {k} rank {r}",
                   got[k], want[k][r * B // world:(r + 1) * B // world])
    elif stage == "detect":
        got, want = _stage(arrays, "detect"), _stage(ref, "detect")
        rep["detect"] = {"max_abs": 0.0}
        for k, v in want.items():
            if v.dtype.kind in "biu":
                _exact(f"detect {k} rank {r}", got[k], v)
            else:
                rep["detect"]["max_abs"] = max(rep["detect"]["max_abs"], _close(
                    f"detect {k} rank {r}", got[k], v, TOL["detect_atol"][kind],
                    TOL["detect_atol"][kind]))
        if report["detect"]["launches"] != ref_report["detect"]["launches"] or \
                report["detect"]["plain_calls"] != ref_report["detect"]["plain_calls"]:
            raise AssertionError(f"detect rank {r}: the attention routed as "
                                 f"{report['detect']} against one process's "
                                 f"{ref_report['detect']}")
    elif stage == "solve":
        got, want = _stage(arrays, "solve"), _stage(ref, "solve")
        scale = max(float(np.abs(v).max()) for v in want.values())
        rep["solve"] = {k: _close(f"solve {k} rank {r}", got[k], v,
                                  TOL["solve_rtol"] * scale, TOL["solve_rtol"])
                        for k, v in want.items()}
    elif stage == "collectives":
        got = _stage(arrays, "collectives")
        x = np.arange(world * 6, dtype=np.float32).reshape(world * 2, 3)
        _exact(f"collectives all_gather rank {r}", got["all_gather"],
               np.stack([np.arange(3.0) + 10 * q for q in range(world)]))
        _exact(f"collectives mean rank {r}", got["mean"],
               [np.mean([2.0 * q for q in range(world)]),
                np.mean([1.0 + q for q in range(world)])])
        _exact(f"collectives sum rank {r}", got["sum"],
               [sum(2.0 * q for q in range(world)), sum(1.0 + q for q in range(world))])
        _exact(f"collectives local rank {r}", got["local"], x[2 * r:2 * r + 2])
        _exact(f"collectives gathered rank {r}", got["gathered"], x)
    elif stage == "lanes":
        rep["lanes"] = _lane_parity(f"lanes rank {r}", _stage(arrays, "lanes"),
                                    _stage(ref, "lanes"))
    elif stage == "assoc_train":
        rep["assoc_train"] = _train_parity(
            "assoc_train", _stage(ref, "assoc_train"), _stage(arrays, "assoc_train"), kind,
            report["assoc_train"]["lr"])


def _lane_parity(where: str, got: dict, want: dict) -> dict:
    """Every scene's output: track frame ids and classes exact, rows within
    ``lane_rows``, bboxes_dl within ``lane_rows``, bboxes_qc at box IoU
    >= ``lane_box_iou``, quadrics' shapes and the overflow report equal."""
    from ..utils.host_boxes import robust_box3d_iou

    if set(got) != set(want):
        raise AssertionError(f"{where}: keys {sorted(set(got) ^ set(want))[:6]}")
    tol = TOL["lane_rows"]
    rep = {"row_max_abs": 0.0, "min_box_iou": 1.0}
    for k, v in want.items():
        parts = k.split("/")
        if parts[-1] == "len":
            _exact(f"{where} {k}", got[k], v)
        elif parts[1] == "tracks":
            _exact(f"{where} {k} ids, classes", got[k][:, :2], v[:, :2])
            rep["row_max_abs"] = max(rep["row_max_abs"], _close(f"{where} {k}", got[k], v,
                                                                tol, tol))
        elif parts[1] == "bboxes_dl":
            _close(f"{where} {k}", got[k], v, tol)
        elif parts[1] == "bboxes_qc":
            iou = robust_box3d_iou(got[k], v)
            rep["min_box_iou"] = min(rep["min_box_iou"], iou)
            if iou < TOL["lane_box_iou"]:
                raise AssertionError(f"{where} {k}: box IoU {iou:.3f}")
        elif parts[1] == "quadrics":
            if got[k].shape != v.shape:
                raise AssertionError(f"{where} {k}: shape {got[k].shape} against {v.shape}")
        else:
            _exact(f"{where} {k}", got[k], v)
    rep["scenes"] = int(want["len"])
    return rep


# ------------------------------------------------------------------- CLI

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.dryrun_distributed",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default nccl on the card, gloo on the CPU")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--size", default="tiny", choices=sorted(SIZES))
    ap.add_argument("--out_dir", default=os.path.join("runs", "dryrun_distributed"))
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds the ranks may take in all")
    ap.add_argument("--threads", type=int, default=None, help="torch threads a rank")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    from .. import resolve_device
    from ..parallel import distributed

    dev = resolve_device(args.device)
    backend = args.backend or distributed.default_backend(dev)
    stages = tuple(args.stages.split(","))
    procs = start(args.world, backend, args.device, args.size, args.out_dir, stages,
                  args.threads)
    try:
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        reference = run_stages(args.size, dev, None, stages)
    finally:
        ranks = wait(procs, args.out_dir, args.timeout)
    report = compare(reference, ranks)
    report["reference"] = reference[1]
    report["ranks"] = [r for _, r in ranks]
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
