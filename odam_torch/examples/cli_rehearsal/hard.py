"""Hard (discriminative) rehearsal scenes.

Counterpart of ``examples/cli_rehearsal/hard.py``, the same NumPy code: the
views, rows and annotations are bit-equal to JAX's.

The standard rehearsal saturates at F1 = 1.0 — 3-4 solid-colored,
non-overlapping boxes on a dark background cannot fail, so it cannot
detect regressions or discriminate config choices.  This generator produces scenes that operate in a measurable F1 band:

- 8-10 objects per scene with SAME-CLASS DUPLICATES (duplicates share the
  class color, so association must disambiguate instances by geometry,
  not appearance);
- procedural layouts from a seed — training uses different seeds than
  evaluation, so the detector generalizes over layouts, not memorizes;
- textured backgrounds (per-scene seeded noise + gradient) and per-frame
  brightness jitter;
- partial occlusion (objects close enough to overlap in view, painter's
  algorithm) and image-border truncation (tight camera ring), exercising
  the edge_threshold=20 constraint masking downstream
  (the reference's src/utils/tracking_gt_utils.py:199);
- pose noise: rendering uses the true camera, the written pose file gets a
  perturbed one — the recorded-trajectory error real SLAM systems have.

Class ids/colors follow .common (mapping/prior.py CLASS_MAPPER).
"""
from __future__ import annotations

import numpy as np

from .common import box_corners_np, cam_azi_np, look_at

# The hard split renders at 192px and feeds the transformer stage-3
# backbone features (stride 16 -> 12x12 grid; rehearsal.yaml
# backbone_stage: 3).  The standard split's 128px/stride-32 4x4 grid
# cannot separate 8-10 objects (measured F1 collapsed to 0), and stage 4's
# whole-image receptive field at this scale blocks held-out-layout
# generalization for the tiny frozen-random-backbone model.
IMG = 192
K = np.array([[150.0, 0, 96], [0, 150.0, 96], [0, 0, 1]], np.float32)

CLASS_COLORS = {
    0: (170, 60, 230),   # display
    1: (60, 255, 60),    # table
    2: (240, 240, 240),  # bathtub
    3: (80, 80, 255),    # trashbin
    4: (250, 180, 40),   # sofa
    5: (255, 60, 60),    # chair
    6: (220, 220, 70),   # cabinet
    7: (60, 200, 220),   # bookshelf
}

CLASS_DIMS = {  # nominal (w, d, h) per class, jittered per instance
    0: (0.9, 0.15, 0.55),
    1: (1.2, 0.7, 0.6),
    2: (0.8, 0.5, 0.55),
    3: (0.4, 0.4, 0.5),
    4: (1.5, 0.7, 0.7),
    5: (0.55, 0.55, 0.9),
    6: (0.9, 0.5, 0.9),
    7: (0.9, 0.35, 1.2),
}

N_FRAMES_HARD = 32
RING_RADIUS = 2.8          # tight -> border truncation
RING_ELEVATION = 1.1
POSE_NOISE_T = 0.015       # meters, written-pose perturbation
POSE_NOISE_R = 0.01        # radians

EVAL_SEEDS = (0, 1, 2)     # on-disk eval scenes: scene97<seed>_00
TUNE_SEEDS = (50, 51, 52)  # operating-point tuning split (never evaluated,
#                            never trained on: training draws [100, 100000))
TRAIN_SEEDS = tuple(range(100, 120))  # held-out layouts for training
# (20 layouts: the tiny random-backbone DETR memorizes 5 — measured
# tp 246/249 on train layouts vs 77/224 on eval layouts)


def hard_scene_id(seed: int) -> str:
    return f"scene97{seed:02d}_00"


def make_hard_objects(seed: int):
    """Procedural layout: 8-10 objects, >=2 same-class duplicate pairs."""
    rng = np.random.default_rng(1000 + seed)
    n_objects = int(rng.integers(7, 10))
    # choose classes: force duplicates
    dup_classes = rng.choice(8, 2, replace=False)
    classes = list(dup_classes) * 2  # two instances each
    while len(classes) < n_objects:
        classes.append(int(rng.integers(0, 8)))
    rng.shuffle(classes)

    objects = []
    placed = []
    for cls in classes:
        dims = np.asarray(CLASS_DIMS[int(cls)]) * rng.uniform(0.85, 1.2, 3)
        for _ in range(40):
            c = np.array([rng.uniform(-1.6, 1.6), rng.uniform(-1.6, 1.6),
                          dims[2] / 2])
            # allow visual overlap but not center collisions
            if all(np.linalg.norm(c[:2] - p[:2]) > 0.7 for p in placed):
                break
        placed.append(c)
        yaw = float(rng.uniform(0, np.pi) + 0.003)  # off the atan2 knife-edge
        objects.append((c, dims, yaw, int(cls), CLASS_COLORS[int(cls)]))
    return objects


def _background(seed: int) -> np.ndarray:
    """Per-scene textured background (seeded: stable across frames)."""
    rng = np.random.default_rng(2000 + seed)
    base = rng.integers(25, 70, 3)
    yy, xx = np.mgrid[0:IMG, 0:IMG].astype(np.float32) / IMG
    grad = (0.6 + 0.4 * yy)[..., None]
    noise = rng.normal(0, 14, (IMG // 4, IMG // 4, 3))
    noise = np.repeat(np.repeat(noise, 4, 0), 4, 1)
    checker = 8.0 * (((xx * 10).astype(int) + (yy * 10).astype(int)) % 2 - 0.5)
    img = base[None, None] * grad + noise + checker[..., None]
    return np.clip(img, 0, 255).astype(np.float32)


def render_hard(objects, T_wc, background, frame_rng, return_vis=False):
    """Painter's render with texture, shading, jitter + GT detector rows.

    Returns (img uint8, rows [n, 12], inst_ids [n]) — inst_ids give the
    OBJECT index per row (same-class duplicates need identity for GT
    association tracks; class alone is ambiguous here by design).

    With ``return_vis`` a fourth array [n, 3] is appended: per row the
    visible fraction of the projected bbox after occlusion + truncation,
    and the visible region's width/height in pixels — what a detector can
    actually see (rows themselves still list every projectable object,
    including fully overpainted ones; that is the benchmark's GT
    convention, analyze_visibility.py measures the resulting ceiling).
    """
    img = background.copy()
    T_cw = np.linalg.inv(T_wc)
    order = []
    for inst, (c, dims, yaw, cls, color) in enumerate(objects):
        corners = box_corners_np(dims, yaw, c)
        pc = corners @ T_cw[:3, :3].T + T_cw[:3, 3]
        if pc[:, 2].min() < 0.3:
            continue
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        x0, y0 = uv.min(0)
        x1, y1 = uv.max(0)
        # visibility: require some part inside the frame (truncation allowed)
        ix0, iy0 = max(int(x0), 0), max(int(y0), 0)
        ix1, iy1 = min(int(x1), IMG), min(int(y1), IMG)
        if ix1 - ix0 < 5 or iy1 - iy0 < 5:
            continue
        order.append((pc[:, 2].mean(), (x0, y0, x1, y1), c, dims, yaw, cls,
                      color, inst))

    rows = []
    inst_ids = []
    full_boxes = {}
    idmap = np.full((IMG, IMG), -1, np.int32) if return_vis else None
    for depth, (x0, y0, x1, y1), c, dims, yaw, cls, color, inst in sorted(
        order, key=lambda o: -o[0]
    ):
        ix0, iy0 = max(int(x0), 0), max(int(y0), 0)
        ix1, iy1 = min(int(x1), IMG), min(int(y1), IMG)
        shade = float(np.clip(1.25 - 0.09 * depth, 0.55, 1.15))
        jitter = frame_rng.uniform(0.9, 1.1, 3)
        block = np.asarray(color, np.float32) * shade * jitter
        # simple per-object texture: two-tone vertical split
        mid = (ix0 + ix1) // 2
        img[iy0:iy1, ix0:mid] = np.clip(block, 0, 255)
        img[iy0:iy1, mid:ix1] = np.clip(block * 0.82, 0, 255)
        if return_vis:
            idmap[iy0:iy1, ix0:ix1] = inst
            full_boxes[inst] = (x1 - x0) * (y1 - y0)

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
        inst_ids.append(inst)
    out = (np.clip(img, 0, 255).astype(np.uint8),
           np.asarray(rows, np.float32), np.asarray(inst_ids, np.int32))
    if not return_vis:
        return out
    vis = np.zeros((len(inst_ids), 3), np.float32)
    for j, inst in enumerate(inst_ids):
        ys, xs = np.nonzero(idmap == inst)
        if len(xs):
            vis[j] = (len(xs) / max(full_boxes[inst], 1e-6),
                      xs.max() - xs.min() + 1, ys.max() - ys.min() + 1)
    return out + (vis,)


def hard_scene_views(seed: int, n_frames: int = N_FRAMES_HARD,
                     phase: float = 0.0, pose_noise: bool = True):
    """Camera ring -> [(frame_id, T_wc_written, img, gt_rows)].

    ``T_wc_written`` carries the pose noise (what the pipeline consumes);
    rendering and GT rows use the true camera.
    """
    objects = make_hard_objects(seed)
    background = _background(seed)
    center = np.mean([o[0] for o in objects], axis=0)
    center[2] = 0.45
    noise_rng = np.random.default_rng(3000 + seed)
    views = []
    for k in range(n_frames):
        phi = 2 * np.pi * (k + phase) / n_frames
        cam = center + np.array([
            RING_RADIUS * np.cos(phi), RING_RADIUS * np.sin(phi),
            RING_ELEVATION,
        ])
        T_true = look_at(cam, center).astype(np.float64)
        frame_rng = np.random.default_rng(4000 + seed * 100 + k)
        img, rows, inst_ids = render_hard(objects, T_true, background, frame_rng)
        T_out = T_true.copy()
        if pose_noise:
            T_out[:3, 3] += noise_rng.normal(0, POSE_NOISE_T, 3)
            w = noise_rng.normal(0, POSE_NOISE_R, 3)
            wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                           [-w[1], w[0], 0]])
            from scipy.linalg import expm

            T_out[:3, :3] = T_out[:3, :3] @ expm(wx)
        views.append((k, T_out.astype(np.float32), img, rows, inst_ids))
    return views


# Training-target visibility gate (hard_random_view): a GT row whose object
# is essentially invisible (overpainted by closer objects / truncated to a
# sliver) is NOISE as a supervision target — it teaches the detector to
# hallucinate boxes from background pixels (measured: 238 fp over 48 eval
# frames when trained on all rows).  The thresholds match the detectability
# criterion in analyze_visibility.py.
TRAIN_VIS_FRAC = 0.35
TRAIN_VIS_PIX = 12


def hard_random_view(rng: np.random.Generator, vis_filter: bool = True):
    """One freshly generated training view: new procedural layout, new
    background, random ring camera.  Layout seeds are drawn from
    [100, 100000) — disjoint from EVAL_SEEDS by construction — so
    end-to-end training never sees an evaluation layout (or any layout
    twice, in expectation): generalization over layouts by construction
    instead of by a fixed cached split.

    Returns (img uint8, gt rows [n, 12]); with ``vis_filter`` (default)
    rows for objects below the visibility gate are dropped from the
    training targets (see TRAIN_VIS_FRAC above — the rendered image is
    identical either way).
    """
    seed = int(rng.integers(100, 100000))
    objects = make_hard_objects(seed)
    background = _background(seed)
    center = np.mean([o[0] for o in objects], axis=0)
    center[2] = 0.45
    phi = float(rng.uniform(0, 2 * np.pi))
    cam = center + np.array([
        RING_RADIUS * np.cos(phi), RING_RADIUS * np.sin(phi), RING_ELEVATION,
    ])
    T_true = look_at(cam, center).astype(np.float64)
    frame_rng = np.random.default_rng(int(rng.integers(2 ** 31)))
    img, rows, _, vis = render_hard(objects, T_true, background, frame_rng,
                                    return_vis=True)
    if vis_filter and len(rows):
        keep = (vis[:, 0] >= TRAIN_VIS_FRAC) & (
            np.minimum(vis[:, 1], vis[:, 2]) >= TRAIN_VIS_PIX)
        rows = rows[keep]
    return img, rows


def hard_gt_world_tracks(seed: int, rng: np.random.Generator,
                         noise: float = 0.02, phase: float = 0.0, keep=None,
                         n_frames: int = N_FRAMES_HARD):
    """Per-INSTANCE GT observation tracks (82-dim world rows) + poses.

    Twin of common.gt_world_tracks for hard scenes — identity comes from
    the renderer's instance ids, because same-class duplicates make
    class-based identity ambiguous (that is the point of these scenes).

    ``keep``: optional (frame_id, inst) -> bool filter; rows it rejects are
    dropped (used by the recall diagnostics to restrict GT tracks to
    frames where the object is actually visible, analyze_visibility.py).
    """
    objects = make_hard_objects(seed)
    tracks = [[] for _ in objects]
    poses = {}
    for fid, T_wc, _, rows, inst_ids in hard_scene_views(
            seed, n_frames=n_frames, phase=phase):
        poses[fid] = T_wc
        for r, inst in zip(rows, inst_ids):
            if keep is not None and not keep(int(fid), int(inst)):
                continue
            c, dims, yaw, cls, _ = objects[int(inst)]
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
            tracks[int(inst)].append(row)
    return [np.stack(t) for t in tracks if t], poses


def hard_scene_annotation(seed: int) -> dict:
    """Scan2CAD-format GT for one hard scene (make_dataset.py schema)."""
    from ...mapping.prior import CLASS_MAPPER

    def yaw_quat(yaw):
        return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]

    objects = make_hard_objects(seed)
    return {
        "id_scan": hard_scene_id(seed),
        "trs": {"translation": [0, 0, 0], "rotation": [1, 0, 0, 0],
                "scale": [1, 1, 1]},
        "aligned_models": [
            {
                "catid_cad": CLASS_MAPPER[cls],
                "id_cad": f"synthetic_{i}",
                "trs": {"translation": [float(v) for v in c],
                        "rotation": yaw_quat(yaw),
                        "scale": [1.0, 1.0, 1.0]},
                "bbox": [float(v) for v in dims / 2],
            }
            for i, (c, dims, yaw, cls, _) in enumerate(objects)
        ],
    }
