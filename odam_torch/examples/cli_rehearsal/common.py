"""Shared definitions for the Scan2CAD CLI rehearsal.

Counterpart of ``examples/cli_rehearsal/common.py``: the scenes, renderer
and ground-truth rows are the same NumPy code; the models are the port's.
A synthetic 3-scene "val split" of procedurally rendered box-world rooms,
written to disk in the exact ScanNet layout ``odam_torch.scripts.run_processor``
consumes and with a matching Scan2CAD `full_annotations.json`, so the
run_processor -> eval_scan2cad CLI chain runs end-to-end without real data.
Classes use the detector's 8-class Scan2CAD mapping (mapping/prior.py
CLASS_MAPPER: 0 display, 1 table, 2 bathtub, 3 trashbin, 4 sofa, 5 chair,
6 cabinet, 7 bookshelf).
"""
import os

import numpy as np
import torch

from ...data.transforms import IMAGENET_MEAN, IMAGENET_STD

_SIGNS = np.array(
    [[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
     [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]], np.float64,
)


def box_corners_np(dims, yaw, center):
    """Host-side twin of geometry.box3d_corners (pure NumPy: the renderer
    runs per frame and reads nothing back from the device)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (_SIGNS * np.asarray(dims) / 2.0) @ R.T + np.asarray(center)


def cam_azi_np(T_wc):
    fwd = T_wc[:3, :3] @ np.array([0.0, 0.0, 1.0])
    return float(np.arctan2(fwd[1], fwd[0]))

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))))
# the rehearsal studies' default outputs and generated splits: git-ignored,
# never under examples/ or artifacts/
RUNS = os.path.join(REPO, "runs", "cli_rehearsal")
DATA_HARD = os.path.join(REPO, "examples", "cli_rehearsal", "data_hard")   # committed, read only
DETR_WEIGHTS = os.path.join(REPO, "artifacts", "torch", "rehearsal_hard_detr.npz")
ASSOC_WEIGHTS = os.path.join(REPO, "artifacts", "torch", "rehearsal_hard_assoc.npz")



def load_params(path: str) -> dict:
    """The Flax tree of rehearsal weights at ``path``: a checkpoint directory
    of the port's trainer or a ``.npz``."""
    from ...models import convert
    from ...utils import checkpoint

    return checkpoint.restore(path)[0] if os.path.isdir(path) else convert.load_flax_npz(path)


IMG = 128
K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)
N_FRAMES = 24

# scene -> [(center, dims, yaw, detector_class, color)]
SCENES = {
    "scene9000_00": [
        (np.array([0.0, 0.0, 0.4]), np.array([0.6, 0.6, 0.8]), 0.4, 5, (255, 60, 60)),
        (np.array([1.5, 0.4, 0.3]), np.array([1.0, 0.6, 0.6]), 2.0, 1, (60, 255, 60)),
        (np.array([-0.4, 1.3, 0.25]), np.array([0.45, 0.4, 0.5]), 1.2, 3, (80, 80, 255)),
    ],
    "scene9001_00": [
        (np.array([0.2, -0.3, 0.35]), np.array([1.4, 0.7, 0.7]), -0.8, 4, (250, 180, 40)),
        (np.array([-1.2, 0.8, 0.45]), np.array([0.55, 0.6, 0.9]), 0.9, 5, (255, 60, 60)),
        (np.array([1.1, 1.2, 0.5]), np.array([0.9, 0.15, 0.55]), 2.4, 0, (170, 60, 230)),
    ],
    "scene9002_00": [
        (np.array([0.8, -0.6, 0.6]), np.array([0.9, 0.35, 1.2]), 1.6, 7, (60, 200, 220)),
        (np.array([-0.9, -0.2, 0.45]), np.array([0.8, 0.5, 0.9]), -1.1, 6, (220, 220, 70)),
        (np.array([0.1, 1.1, 0.3]), np.array([1.1, 0.7, 0.6]), 0.2, 1, (60, 255, 60)),
        (np.array([-0.2, -1.4, 0.3]), np.array([0.8, 0.5, 0.55]), 2.8, 2, (240, 240, 240)),
    ],
}


def look_at(cam, target):
    fwd = target - cam
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, cam
    return T


def render(objects, T_wc):
    """Painter's-algorithm render of colored box objects + GT detector rows.

    Returns (uint8 image [IMG, IMG, 3], objects [n, 12]) — the DetectorDataset
    row layout: [cls, cx, cy, w, h (normalized), dims(3), offset(2, norm),
    depth, azi_co].
    """
    img = np.full((IMG, IMG, 3), 30, np.uint8)
    T_cw = np.linalg.inv(T_wc)
    order = []
    for (c, dims, yaw, cls, color) in objects:
        corners = box_corners_np(dims, yaw, c)
        pc = corners @ T_cw[:3, :3].T + T_cw[:3, 3]
        if pc[:, 2].min() < 0.3:
            continue
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        x0, y0 = uv.min(0)
        x1, y1 = uv.max(0)
        if x1 < 5 or y1 < 5 or x0 > IMG - 5 or y0 > IMG - 5:
            continue
        order.append((pc[:, 2].mean(), (x0, y0, x1, y1), c, dims, yaw, cls, color))
    rows = []
    for depth, (x0, y0, x1, y1), c, dims, yaw, cls, color in sorted(
        order, key=lambda o: -o[0]
    ):
        img[max(int(y0), 0):min(int(y1), IMG), max(int(x0), 0):min(int(x1), IMG)] = color
        t_co = T_cw[:3, :3] @ c + T_cw[:3, 3]
        proj = K @ t_co
        sc = proj[:2] / proj[2]
        cam_azi = cam_azi_np(T_wc)
        rows.append(
            [cls, (x0 + x1) / 2 / IMG, (y0 + y1) / 2 / IMG, (x1 - x0) / IMG,
             (y1 - y0) / IMG, dims[0], dims[1], dims[2],
             (sc[0] - (x0 + x1) / 2) / IMG, (sc[1] - (y0 + y1) / 2) / IMG,
             t_co[2], yaw - cam_azi]
        )
    return img, np.asarray(rows, np.float32)


def scene_views(scene_id: str, n_frames: int = N_FRAMES, phase: float = 0.0):
    """Camera ring around the scene -> [(frame_id, T_wc, img, gt_rows)]."""
    objects = SCENES[scene_id]
    center = np.mean([o[0] for o in objects], axis=0)
    center[2] = 0.4
    views = []
    for k in range(n_frames):
        phi = 2 * np.pi * (k + phase) / n_frames
        cam = center + np.array([3.4 * np.cos(phi), 3.4 * np.sin(phi), 1.2])
        T_wc = look_at(cam, center).astype(np.float32)
        img, rows = render(objects, T_wc)
        views.append((k, T_wc, img, rows))
    return views


def make_detr(num_queries: int = 12, backbone_stage: int = 4,
              backbone: str = "resnet50", use_kernels: bool = True):
    """The rehearsal DETR's config (``model, cfg`` in JAX): build it with
    ``detr.build_detr(cfg, ...)``.  Training turns ``use_kernels`` off."""
    from ...models import detr as detr_mod

    return detr_mod.DETRConfig(
        num_classes=8, num_queries=num_queries, hidden_dim=64, nheads=4,
        enc_layers=2, dec_layers=2, dim_feedforward=256,
        aux_loss=True, dropout=0.0, dtype=torch.float32,
        backbone_stage=backbone_stage, backbone=backbone, use_kernels=use_kernels,
    )


def make_assoc(use_kernels: bool = True):
    """The rehearsal associator's config: build it with
    ``associator.build_associator(cfg, ...)``."""
    from ...models import associator as assoc_mod

    return assoc_mod.AssociatorConfig(
        descriptor_dim=64, keypoint_encoder=(78, 64, 64),
        gnn_layers=("self", "cross", "self", "cross"),
        self_gnn_layers=("self",), sinkhorn_iterations=30, use_kernels=use_kernels,
    )


def norm(img):
    return ((img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)


def gt_world_tracks(scene_id: str, rng: np.random.Generator,
                    noise: float = 0.02, phase: float = 0.0):
    """Per-object GT observation tracks in the pipeline's 82-dim world-row
    layout plus per-frame poses, for associator training.

    Returns (tracks: list of [n_obs, 82] arrays, poses: {frame_id: T_wc}).
    """
    objects = SCENES[scene_id]
    tracks = [[] for _ in objects]
    poses = {}
    for fid, T_wc, _, rows in scene_views(scene_id, phase=phase):
        poses[fid] = T_wc
        for r in rows:
            cls = int(r[0])
            t_idx = next(i for i, o in enumerate(objects) if o[3] == cls)
            c, dims, yaw, _, _ = objects[t_idx]
            row = np.full((82,), -1.0, np.float32)
            row[0] = fid
            row[1] = cls
            bbox = np.array([r[1] - r[3] / 2, r[2] - r[4] / 2,
                             r[1] + r[3] / 2, r[2] + r[4] / 2]) * IMG
            row[2:6] = bbox + rng.normal(0, noise * IMG, 4)
            row[6:9] = dims + rng.normal(0, noise, 3)
            row[9:12] = c + rng.normal(0, noise, 3)
            row[12] = yaw + rng.normal(0, noise)
            row[13] = 0.95
            row[78:82] = row[2:6]
            tracks[t_idx].append(row)
    return [np.stack(t) for t in tracks if t], poses
