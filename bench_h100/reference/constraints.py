# Frozen copy of the parts of odam_torch/mapping/constraints.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Track -> multi-view constraint conversion (a copy of
``odam_tpu/mapping/constraints.py``).

Host-side (NumPy) packing of ragged per-object track observations into the
fixed-shape tensors the on-device optimizer consumes.  Capability parity with
the reference's load_pred_object (tracking_gt_utils.py:145-211) and the
per-object setup in run_multi_view.py:22-58:

- each observed frame contributes up to 4 box-edge values (x_min, y_min,
  x_max, y_max in pixels), with edges within ``edge_threshold`` px of the
  image border dropped (occlusion-truncation handling, edge_threshold=20);
- object init = mean translation, circular-mean yaw, mean dimensions over the
  track's observations;
- objects observed in fewer than ``min_views`` frames keep their
  detector-average box and are excluded from optimization.

Track row layout (82 columns, reference processor.py:98-108):
  0 frame_id | 1 class | 2:6 bbox xyxy (pixels) | 6:9 dims | 9:12 t_wo |
  12 azi_wo | 13 score | 14:78 feature code | 78:82 projected bbox.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TRACK_DIM = 82
EDGE_THRESHOLD = 20.0


@dataclass
class SceneConstraints:
    """Fixed-shape constraint tensors for one scene (all NumPy, ready for device)."""

    boxes: np.ndarray        # [O, V, 4] observed box-edge values (pixels)
    box_mask: np.ndarray     # [O, V, 4] 1 where the edge constraint is active
    view_mask: np.ndarray    # [O, V]    1 where the view slot holds a real observation
    P_cw: np.ndarray         # [O, V, 3, 4] projection matrices per view slot
    init_translate: np.ndarray  # [O, 3]
    init_angle: np.ndarray      # [O]
    init_dims: np.ndarray       # [O, 3]
    obj_class: np.ndarray       # [O] int
    n_views: np.ndarray         # [O] int (true observation count, pre-subsample)
    obj_valid: np.ndarray       # [O] bool (slot holds a real object)
    optimize_mask: np.ndarray   # [O] bool (valid and n_views >= min_views)


def edge_constraints(bbox_xyxy: np.ndarray, img_h: float, img_w: float,
                     edge_threshold: float = EDGE_THRESHOLD) -> np.ndarray:
    """Per-edge activity mask for one or more boxes: [..., 4] -> [..., 4] bool.

    Reference behavior: quadric_helper.py:69-109 (bbox_to_lines) — an edge is
    kept only if strictly inside the border band.
    """
    b = np.asarray(bbox_xyxy)
    lo_x, hi_x = edge_threshold, img_w - edge_threshold
    lo_y, hi_y = edge_threshold, img_h - edge_threshold
    mask = np.stack(
        [
            (b[..., 0] > lo_x) & (b[..., 0] < hi_x),
            (b[..., 1] > lo_y) & (b[..., 1] < hi_y),
            (b[..., 2] > lo_x) & (b[..., 2] < hi_x),
            (b[..., 3] > lo_y) & (b[..., 3] < hi_y),
        ],
        axis=-1,
    )
    return mask


def _circular_mean(angles: np.ndarray) -> float:
    """Chordal mean of yaw angles — equivalent to the reference's rotation
    averaging for z-only rotations (tracking_gt_utils.py:59-66)."""
    return float(np.arctan2(np.mean(np.sin(angles)), np.mean(np.cos(angles))))


def _circular_median(angles: np.ndarray) -> float:
    """Angular median: the observed yaw minimizing summed wrapped |distance|
    to the others (robust to a few truncated-view outlier rows)."""
    a = np.asarray(angles, np.float64)
    d = np.abs(np.angle(np.exp(1j * (a[:, None] - a[None, :]))))
    return float(a[np.argmin(d.sum(axis=1))])


def build_scene_constraints(
    tracks: list[np.ndarray],
    frame_ids: np.ndarray,
    P_cws: np.ndarray,
    img_h: float,
    img_w: float,
    max_objs: int,
    max_views: int,
    min_views: int = 10,
    edge_threshold: float = EDGE_THRESHOLD,
    robust_init: bool = False,
) -> SceneConstraints:
    """Pack ragged tracks into fixed-shape constraint tensors.

    Args:
        tracks: list of [n_obs, 82] arrays (one per object).
        frame_ids: [F] usable frame ids of the scene, aligned with P_cws.
        P_cws: [F, 3, 4] world->pixel projection per usable frame.
        max_objs: O (objects beyond this are dropped, longest-first).
        max_views: V (observations beyond this are uniformly strided down).
        robust_init: median (instead of mean) per-row translation/dims and
            the angular-median yaw for the object init state.  The round-5
            miss decomposition (audit_misses.py, MEASURED.md) found the
            dominant bad_box cause is AGGREGATION — single-frame detector
            estimates clear the 0.25 gate but the mean over a track with a
            few truncated-view outlier rows does not — and the same mean
            also seeds the solver and the detector-average fallback box.
            Default False = the reference's mean semantics
            (run_multi_view.py:49 get_3d_box on the averaged track state).
    """
    frame_ids = np.asarray(frame_ids)
    P_cws = np.asarray(P_cws, dtype=np.float32)
    frame_index = {int(f): i for i, f in enumerate(frame_ids)}

    order = np.argsort([-len(t) for t in tracks], kind="stable")[:max_objs]
    O, V = max_objs, max_views

    out = SceneConstraints(
        boxes=np.zeros((O, V, 4), np.float32),
        box_mask=np.zeros((O, V, 4), np.float32),
        view_mask=np.zeros((O, V), np.float32),
        P_cw=np.zeros((O, V, 3, 4), np.float32),
        init_translate=np.zeros((O, 3), np.float32),
        init_angle=np.zeros((O,), np.float32),
        init_dims=np.full((O, 3), 0.1, np.float32),
        obj_class=np.zeros((O,), np.int32),
        n_views=np.zeros((O,), np.int32),
        obj_valid=np.zeros((O,), bool),
        optimize_mask=np.zeros((O,), bool),
    )

    for slot, t_idx in enumerate(order):
        track = np.asarray(tracks[t_idx])
        if track.ndim != 2 or len(track) == 0:
            continue
        # Observations actually present in the usable-frame list.
        obs_rows = [
            (frame_index[int(r[0])], r) for r in track if int(r[0]) in frame_index
        ]
        if not obs_rows:
            continue
        rows = np.stack([r for _, r in obs_rows])
        fids = np.array([i for i, _ in obs_rows])

        out.obj_valid[slot] = True
        out.obj_class[slot] = int(np.median(rows[:, 1]))
        if robust_init:
            out.init_translate[slot] = np.median(rows[:, 9:12], axis=0)
            out.init_angle[slot] = _circular_median(rows[:, 12])
            out.init_dims[slot] = np.median(rows[:, 6:9], axis=0)
        else:
            out.init_translate[slot] = rows[:, 9:12].mean(axis=0)
            out.init_angle[slot] = _circular_mean(rows[:, 12])
            out.init_dims[slot] = rows[:, 6:9].mean(axis=0)
        out.n_views[slot] = len(rows)
        out.optimize_mask[slot] = len(rows) >= min_views

        if len(rows) > max_views:
            pick = np.linspace(0, len(rows) - 1, max_views).round().astype(int)
            rows = rows[pick]
            fids = fids[pick]
        k = len(rows)
        out.view_mask[slot, :k] = 1.0
        out.boxes[slot, :k] = rows[:, 2:6]
        out.box_mask[slot, :k] = edge_constraints(
            rows[:, 2:6], img_h, img_w, edge_threshold
        ).astype(np.float32)
        out.P_cw[slot, :k] = P_cws[fids]

    return out
