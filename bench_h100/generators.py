"""Traffic generators: frozen copies of ``chip_smoke.py``'s ``_intrinsics``,
``_populate_store``, ``_look_at``, ``_box_corners`` and ``synthetic_scene``,
with the lane camera path of ``odam_torch/scripts/bench_scene_parallel.py``'s
``pose``.  Everything is drawn from a ``numpy.random.Generator`` or a
``torch.Generator`` that the caller seeds, so a seed gives the same traffic.
"""
from __future__ import annotations

import numpy as np
import torch


def intrinsics(img_h: int, img_w: int) -> np.ndarray:
    """ScanNet's 968x1296 color intrinsics scaled to the frame."""
    return np.array([[1170.0 * img_w / 1296, 0, img_w / 2],
                     [0, 1170.0 * img_h / 968, img_h / 2], [0, 0, 1]], np.float32)


def lane_pose(f: float, lane: int, phase: float) -> np.ndarray:
    """A smooth camera path a lane: a turn of 0.02 rad and a step of 5 cm a
    frame, each lane at its own heading ``phase``."""
    T = np.eye(4, dtype=np.float32)
    phi = 0.02 * f + phase
    T[:3, :3] = np.array([[np.cos(phi), -np.sin(phi), 0],
                          [np.sin(phi), np.cos(phi), 0], [0, 0, 1]], np.float32)
    T[:3, 3] = [0.05 * f, 0.1 * lane, 1.4]
    return T


def frame_pool(generator: torch.Generator, n: int, lanes: int, img_h: int, img_w: int,
               device: torch.device) -> torch.Tensor:
    """[n, lanes, H, W, 3] uint8 frames drawn on ``device``, then held in
    pinned host memory: every lane its own frames."""
    frames = torch.randint(0, 256, (n, lanes, img_h, img_w, 3), generator=generator,
                           device=device, dtype=torch.uint8)
    if device.type != "cuda":
        return frames
    host = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(frames)
    return host


def filled_window(rng: np.random.Generator, cap: int, W: int, img_h: float, img_w: float,
                  occ: int, hist: int) -> dict[str, np.ndarray]:
    """One store's contents, as ``_populate_store`` sets them: ``occ``
    plausible tracks with ``hist``-observation histories, so the associator,
    Sinkhorn and the decode run against a filled store."""
    win = np.full((cap, W, 82), -1.0, np.float32)
    for t in range(occ):
        win[t, :hist, 0] = np.arange(hist)
        win[t, :hist, 1] = t % 8
        mx, my = img_w // 4, img_h // 4
        cx, cy = rng.uniform(mx, img_w - mx), rng.uniform(my, img_h - my)
        w2, h2 = rng.uniform(mx // 5 + 1, mx), rng.uniform(my // 5 + 1, my)
        win[t, :hist, 2:6] = [cx - w2, cy - h2, cx + w2, cy + h2]
        win[t, :hist, 6:9] = rng.uniform(0.3, 1.8, 3)
        win[t, :hist, 9:12] = rng.uniform(-3, 3, 3) + [0, 0, 1.2]
        win[t, :hist, 12] = rng.uniform(-3, 3)
        win[t, :hist, 13] = 0.9
        win[t, :hist, 78:82] = win[t, :hist, 2:6]
    active = np.arange(cap) < occ
    return {
        "window": win,
        "length": np.where(active, hist, 0).astype(np.int32),
        "n_obs": np.where(active, hist, 0).astype(np.int32),
        "sum_t": (win[:, :hist, 9:12].sum(1) * active[:, None]).astype(np.float32),
        "sum_azi": (win[:, :hist, 12].sum(1) * active).astype(np.float32),
        "sum_dims": (win[:, :hist, 6:9].sum(1) * active[:, None]).astype(np.float32),
        "active": active,
        "count": np.asarray(occ, np.int32),
        "track_id": np.where(active, np.arange(cap), -1).astype(np.int32),
        "last_frame": np.where(active, float(hist - 1), -1.0).astype(np.float32),
        "next_id": np.asarray(occ, np.int32),
    }


def look_at(cam: np.ndarray, target: np.ndarray) -> np.ndarray:
    """T_wc of a z-up world camera at ``cam`` whose optical axis meets ``target``."""
    fwd = (target - cam) / np.linalg.norm(target - cam)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    T_wc = np.eye(4)
    T_wc[:3, 0], T_wc[:3, 1], T_wc[:3, 2], T_wc[:3, 3] = right, np.cross(fwd, right), fwd, cam
    return T_wc


def box_corners(dims, yaw, center) -> np.ndarray:
    signs = np.array([[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
                      [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]], np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (signs * np.asarray(dims) / 2) @ R.T + center


def synthetic_scene(rng: np.random.Generator, n_objs: int, n_views: int, img_h: int,
                    img_w: int):
    """Ground-truth boxes on a grid over the 8 Scan2CAD classes, seen by a
    ring of look-at cameras; every view in which an object lies in front of
    the camera and inside the image gives one 82-column track row: the
    projected box with 1.5 px of detector noise, and the detector's 3D
    estimate, biased per object and noisy per view.  Column 14 holds the
    object's index.  Returns (tracks, frame ids, T_wcs, K, gt)."""
    side = int(np.ceil(np.sqrt(n_objs)))
    K = intrinsics(img_h, img_w).astype(np.float64)
    gt = []
    for o in range(n_objs):
        dims = rng.uniform([0.3, 0.3, 0.4], [0.8, 0.8, 1.3])
        center = np.array([(o % side - (side - 1) / 2) * 1.1, (o // side - (side - 1) / 2) * 1.1,
                           dims[2] / 2]) + np.r_[rng.uniform(-0.1, 0.1, 2), 0.0]
        gt.append((dims, rng.uniform(-np.pi, np.pi), center, o % 8))
    bias = [(rng.normal(0, 0.2, 3), rng.uniform(0.75, 1.25, 3), rng.normal(0, 0.15))
            for _ in range(n_objs)]
    radius = 0.7 * side
    T_wcs, tracks = [], [[] for _ in range(n_objs)]
    for f in range(n_views):
        phi = 2 * np.pi * f / n_views
        T_wc = look_at(np.array([radius * np.cos(phi), radius * np.sin(phi), 1.6]),
                       np.array([0.0, 0.0, 0.4]))
        T_wcs.append(T_wc.astype(np.float32))
        P = K @ np.linalg.inv(T_wc)[:3, :]
        for o, (dims, yaw, center, cls) in enumerate(gt):
            pix = np.c_[box_corners(dims, yaw, center), np.ones(8)] @ P.T
            if (pix[:, 2] < 0.5).any():
                continue
            uv = pix[:, :2] / pix[:, 2:]
            box = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()])
            box = np.clip(box + rng.normal(0, 1.5, 4), 0, [img_w, img_h, img_w, img_h])
            if box[2] - box[0] < 4 or box[3] - box[1] < 4:
                continue
            row = np.full(82, -1.0, np.float32)
            row[0], row[1], row[13], row[14] = f, cls, 0.9, o
            row[2:6] = row[78:82] = box
            d_center, d_scale, d_yaw = bias[o]
            row[6:9] = dims * d_scale * rng.uniform(0.9, 1.1, 3)
            row[9:12] = center + d_center + rng.normal(0, 0.08, 3)
            row[12] = yaw + d_yaw + rng.normal(0, 0.05)
            tracks[o].append(row)
    return [np.asarray(t) for t in tracks], list(range(n_views)), T_wcs, K.astype(np.float32), gt


def fragment(rng: np.random.Generator, tracks: list[np.ndarray], n_split: int
             ) -> list[np.ndarray]:
    """``n_split`` of the tracks (drawn from ``rng``) each cut in two at a
    view in the middle half of its rows, as a tracker that lost an object
    and found it again gives them: the fragments follow the whole tracks."""
    long_enough = [i for i, t in enumerate(tracks) if len(t) >= 4]
    split = set(rng.choice(long_enough, size=min(n_split, len(long_enough)), replace=False)
                .tolist())
    whole, parts = [], []
    for i, t in enumerate(tracks):
        if i in split:
            cut = int(rng.integers(len(t) // 4, 3 * len(t) // 4 + 1))
            cut = min(max(cut, 1), len(t) - 1)
            whole.append(t[:cut])
            parts.append(t[cut:])
        else:
            whole.append(t)
    return whole + parts
