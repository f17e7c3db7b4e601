"""Example: multi-view superquadric mapping on a synthetic posed-video scene.

    python -m odam_torch.examples.synthetic_mapping [--device cpu]

Counterpart of ``examples/synthetic_mapping.py``.  No dataset or weights
needed: builds noisy multi-view 2D box observations of known 3D objects,
packs them as tracks, optimizes superquadrics for all objects at once
(twice: the first run warms up, the second is timed), reports
oriented-3D-IoU against ground truth, and merges duplicate tracks.
:func:`run` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import resolve
from ..mapping import constraints, merge, optimizer, prior, superquadric as sq
from ..utils import host_boxes
from .closed_loop.closed_scene import box_corners

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
IMG_H, IMG_W = 480, 640
N_FRAMES = 60
# (center, dims, yaw, class): a chair and a table; the chair's track is
# split in two fragments (even and odd frames)
OBJECTS = [
    (np.array([0.0, 0.0, 0.45]), np.array([0.55, 0.55, 0.9]), 0.3, 5),
    (np.array([1.6, 0.4, 0.35]), np.array([1.4, 0.8, 0.7]), -0.2, 1),
]


def look_at(cam, target):
    fwd = target - cam
    fwd /= np.linalg.norm(fwd)
    up = np.array([0., 0., 1.])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0] = right
    T[:3, 1] = down
    T[:3, 2] = fwd
    T[:3, 3] = cam
    return T


def build_scene(n_frames: int = N_FRAMES):
    """(tracks: 3 lists of 82-dim rows, frame_ids, P_cws [F, 3, 4])."""
    frame_ids = np.arange(n_frames)
    P_cws, tracks = [], [[] for _ in range(len(OBJECTS) + 1)]   # + the chair's fragment
    rngn = np.random.default_rng(0)
    for f in range(n_frames):
        phi = 0.8 * np.pi * f / n_frames
        cam = np.array([2.8 * np.cos(phi), 2.8 * np.sin(phi), 1.4])
        T_wc = look_at(cam, np.array([0.8, 0.2, 0.5]))
        P = (K @ np.linalg.inv(T_wc)[:3, :]).astype(np.float32)
        P_cws.append(P)
        for oi, (center, dims, yaw, cls) in enumerate(OBJECTS):
            corners = box_corners(dims, yaw, center)
            hom = np.concatenate([corners, np.ones((8, 1))], 1)
            pix = hom @ P.T
            uv = pix[:, :2] / pix[:, 2:]
            box = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()])
            box += rngn.normal(0, 1.5, 4)  # detector noise in pixels
            row = np.zeros(82)
            row[0] = f
            row[1] = cls
            row[2:6] = box
            row[6:9] = dims * rngn.uniform(0.85, 1.15, 3)
            row[9:12] = center + rngn.normal(0, 0.08, 3)
            row[12] = yaw + rngn.normal(0, 0.05)
            row[13] = 0.9
            dest = 0 if oi == 0 and f % 2 == 0 else (2 if oi == 0 else 1)
            tracks[dest].append(row)
    return [np.asarray(t) for t in tracks], frame_ids, np.asarray(P_cws)


def scene_constraints(tracks, frame_ids, P_cws) -> constraints.SceneConstraints:
    return constraints.build_scene_constraints(tracks, frame_ids, P_cws, IMG_H, IMG_W,
                                               max_objs=8, max_views=64, min_views=10)


def solve(sc: constraints.SceneConstraints, device, n_iters: int = 200,
          n_samples: int = 500) -> optimizer.OptimizeResult:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    init = sq.init_params(t(sc.init_translate), t(sc.init_angle), t(sc.init_dims))
    return optimizer.optimize_superquadrics(
        init, t(sc.boxes), t(sc.box_mask), t(sc.view_mask), t(sc.P_cw), t(sc.optimize_mask),
        t(prior.prior_invcov_for_classes(sc.obj_class)), n_iters=n_iters, n_samples=n_samples)


def run(device: str = "cuda", n_iters: int = 200, n_samples: int = 500,
        verbose: bool = True) -> dict:
    dev = resolve(device)
    tracks, frame_ids, P_cws = build_scene()
    if verbose:
        print(f"scene: {len(tracks)} tracks, lengths {[len(t) for t in tracks]}, "
              f"{len(frame_ids)} frames")
    sc = scene_constraints(tracks, frame_ids, P_cws)
    if verbose:
        print("optimize_mask:", sc.optimize_mask, "n_views:", sc.n_views[:4])
    res = solve(sc, dev, n_iters, n_samples)
    res.corners.cpu()
    t0 = time.time()
    res = solve(sc, dev, n_iters, n_samples)
    corners = res.corners.cpu().numpy()
    dt = time.time() - t0
    loss_log = res.loss_log.cpu().numpy()
    if verbose:
        print(f"optimization (8 obj slots x {n_iters} iters x {n_samples} pts, {dev.type}): "
              f"{dt:.2f}s")
        print("loss: %.1f -> %.3f" % (loss_log[0], loss_log[-1]))

    # slot order: longest first = track1 (table, 60), track0 (chair, 30), track2 (chair, 30)
    gt = {cls: box_corners(dims, yaw, center) for (center, dims, yaw, cls) in OBJECTS}
    ious = []
    for slot in range(3):
        cls = int(sc.obj_class[slot])
        iou, _ = host_boxes.box3d_iou(np.asarray(corners[slot], np.float64), gt[cls])
        ious.append(iou)
        if verbose:
            print(f"slot {slot} class {cls} n_views {sc.n_views[slot]}: "
                  f"oriented-3D-IoU vs GT = {iou:.3f}")

    # merge: the two chair fragments should fuse
    valid_slots = [i for i in range(len(sc.obj_valid)) if sc.obj_valid[i]]
    order = np.argsort([-len(t) for t in tracks])
    slot_tracks = [tracks[t_idx] for t_idx in order[:len(valid_slots)]]
    merged = merge.merge_tracks(slot_tracks, [corners[i] for i in range(len(slot_tracks))],
                                frame_ids)
    if verbose:
        print(f"merge: {len(slot_tracks)} tracks -> {len(merged)} "
              f"(chair fragments fused: {len(merged) == 2})")
    return {"constraints": sc, "loss_log": loss_log, "corners": corners, "ious": ious,
            "n_merged": len(merged), "solve_seconds": dt}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.synthetic_mapping",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main(sys.argv[1:])
