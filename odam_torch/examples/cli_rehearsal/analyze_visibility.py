"""Per-object visibility audit for the hard rehearsal eval scenes.

Answers: what recall can the pipeline POSSIBLY reach at min_views=10,
given occlusion/truncation?  For each GT instance and frame we compute the
unoccluded fraction of its projected bbox (painter's order: closer boxes
paint over farther ones) and its in-frame fraction, then count "detectable"
frames under a visibility threshold.  Objects with < min_views detectable
frames are unrecoverable by ANY detector at the eval operating point —
that ceiling separates detector/tracking losses from benchmark-design
losses.

    python -m odam_torch.examples.cli_rehearsal.analyze_visibility

Counterpart of ``examples/cli_rehearsal/analyze_visibility.py``, the same
NumPy code (the rehearsal trainer's associator stream and the detector
probe read :func:`visible_flags`).
"""
from __future__ import annotations

import numpy as np

from . import hard
from .common import box_corners_np


def frame_boxes(objects, T_wc):
    """Projected bbox + mean depth per instance visible in this frame."""
    T_cw = np.linalg.inv(T_wc)
    out = {}
    for inst, (c, dims, yaw, cls, color) in enumerate(objects):
        corners = box_corners_np(dims, yaw, c)
        pc = corners @ T_cw[:3, :3].T + T_cw[:3, 3]
        if pc[:, 2].min() < 0.3:
            continue
        uv = pc @ hard.K.T
        uv = uv[:, :2] / uv[:, 2:]
        x0, y0 = uv.min(0)
        x1, y1 = uv.max(0)
        ix0, iy0 = max(int(x0), 0), max(int(y0), 0)
        ix1, iy1 = min(int(x1), hard.IMG), min(int(y1), hard.IMG)
        if ix1 - ix0 < 5 or iy1 - iy0 < 5:
            continue
        out[inst] = (pc[:, 2].mean(), (x0, y0, x1, y1), (ix0, iy0, ix1, iy1))
    return out


def visible_flags(seed, vis_thresh=0.35, min_pix=12,
                  n_frames=hard.N_FRAMES_HARD):
    """Per-(frame, instance) detectability flags for one hard scene.

    Returns (objects, flags [n_frames, n_objects] bool, listed counts,
    mean visible fraction per object).  "Detectable" = at least
    ``vis_thresh`` of the projected bbox unoccluded and in-frame, with the
    visible region at least ``min_pix`` on its short side — a proxy for
    what a perfect detector could possibly report from pixels.
    """
    objects = hard.make_hard_objects(seed)
    n = len(objects)
    views = hard.hard_scene_views(seed, n_frames=n_frames, pose_noise=False)
    flags = np.zeros((len(views), n), bool)
    listed = np.zeros(n, int)          # frames where GT row exists
    mean_vis = np.zeros(n)
    for fid, T_wc, img, rows, inst_ids in views:
        boxes = frame_boxes(objects, T_wc)
        for i in inst_ids:
            listed[int(i)] += 1
        # paint a per-pixel id map in painter's order (far -> near)
        idmap = np.full((hard.IMG, hard.IMG), -1, np.int32)
        for inst, (depth, full, clip) in sorted(
            boxes.items(), key=lambda kv: -kv[1][0]
        ):
            ix0, iy0, ix1, iy1 = clip
            idmap[iy0:iy1, ix0:ix1] = inst
        for inst, (depth, full, clip) in boxes.items():
            x0, y0, x1, y1 = full
            full_area = max((x1 - x0) * (y1 - y0), 1e-6)
            vis_pix = int((idmap == inst).sum())
            frac = vis_pix / full_area  # folds in truncation + occlusion
            mean_vis[inst] += frac
            ix0, iy0, ix1, iy1 = clip
            w = h = 0
            if vis_pix:
                ys, xs = np.nonzero(idmap[iy0:iy1, ix0:ix1] == inst)
                if len(xs):
                    w, h = xs.max() - xs.min() + 1, ys.max() - ys.min() + 1
            if frac >= vis_thresh and min(w, h) >= min_pix:
                flags[fid, inst] = True
    return objects, flags, listed, mean_vis / max(len(views), 1)


def occlusion_audit(seed, vis_thresh=0.35, min_pix=12):
    objects, flags, listed, mean_vis = visible_flags(seed, vis_thresh, min_pix)
    return objects, flags.sum(0), listed, mean_vis


def main():
    min_views = 10
    total = reachable = 0
    print(f"visibility threshold 0.35 of projected bbox, min side 12 px, "
          f"min_views {min_views}, {hard.N_FRAMES_HARD} frames/scene")
    for seed in hard.EVAL_SEEDS:
        objects, det, listed, mv = occlusion_audit(seed)
        print(f"\n{hard.hard_scene_id(seed)}: {len(objects)} objects")
        for i, (c, dims, yaw, cls, _) in enumerate(objects):
            ok = "OK " if det[i] >= min_views else "LOST"
            print(f"  obj{i} cls{cls}: detectable {det[i]:2d}/32 frames "
                  f"(GT-listed {listed[i]:2d}, mean visible frac {mv[i]:.2f}) {ok}")
        total += len(objects)
        reachable += int((det >= min_views).sum())
    print(f"\nreachable recall ceiling at min_views={min_views}: "
          f"{reachable}/{total} = {reachable / total:.3f}")
    for t in (4, 6, 8, 12):
        r = 0
        tot = 0
        for seed in hard.EVAL_SEEDS:
            _, det, _, _ = occlusion_audit(seed)
            r += int((det >= t).sum())
            tot += len(_ if False else det)
        print(f"  min_views={t:2d}: ceiling {r}/{tot} = {r / tot:.3f}")


if __name__ == "__main__":
    main()
