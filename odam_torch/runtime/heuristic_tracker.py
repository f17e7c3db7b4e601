"""Heuristic (non-learned) detection-to-track association baseline.

Counterpart of ``odam_tpu/runtime/heuristic_tracker.py``, host NumPy as
there, kept identical call for call (the reference's IoU/feature tracker,
src/scripts/run_tracking.py:37-248): greedy matching of detections to
tracks by 2D box IoU (for recently-seen tracks) with an axis-aligned 3D IoU
fallback, an optional point-reprojection containment cost solved with
linear assignment when RGB-D is available, per-object 3D point clouds
maintained by unprojecting in-box keypoints, and deactivation of tracks
unseen for more than ``max_gap`` frames.

Keypoints come from OpenCV ORB when cv2 imports, else from a uniform grid
(the depth-unprojection logic is the same either way).

Two quirks of the reference are kept on purpose, so that both packages
give the same tracks (ROADMAP.md, Queue 3): ``_match_by_points`` divides
the camera-frame cloud by its depth but never applies ``K``, so normalized
coordinates are tested against a box in pixels and the point match almost
never fires; and ``run_tracking`` finds the keypoints on the raw frame
while the boxes are in the resized frame's pixels.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class HeuristicTrack:
    track_id: int
    rows: list = field(default_factory=list)   # per-obs [frame, class, box4, dims3, t_wo3, angle, score]
    points: np.ndarray | None = None           # [P, 3] world points

    @property
    def last(self):
        return self.rows[-1]

    def mean_dims(self) -> np.ndarray:
        return np.mean([r[6:9] for r in self.rows], axis=0)

    def mean_t(self) -> np.ndarray:
        return np.mean([r[9:12] for r in self.rows], axis=0)


def _iou_2d(a: np.ndarray, b: np.ndarray) -> float:
    lo = np.maximum(a[:2], b[:2])
    hi = np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(hi - lo, 0, None))
    ua = np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter
    return float(inter / ua) if ua > 0 else 0.0


def _iou_3d_aabb(c1: np.ndarray, d1: np.ndarray, c2: np.ndarray, d2: np.ndarray) -> float:
    lo = np.maximum(c1 - d1 / 2, c2 - d2 / 2)
    hi = np.minimum(c1 + d1 / 2, c2 + d2 / 2)
    inter = np.prod(np.clip(hi - lo, 0, None))
    u = np.prod(d1) + np.prod(d2) - inter
    return float(inter / u) if u > 0 else 0.0


def detect_keypoints(img: np.ndarray, grid_step: int = 16) -> np.ndarray:
    """[N, 2] (x, y) keypoints: ORB when available, else a uniform grid."""
    try:
        import cv2

        orb = cv2.ORB_create()
        kps = orb.detect(img, None)
        if kps:
            return np.stack([np.asarray(k.pt) for k in kps])
    except ImportError:
        pass
    h, w = img.shape[:2]
    ys, xs = np.mgrid[grid_step // 2 : h : grid_step, grid_step // 2 : w : grid_step]
    return np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)


class HeuristicTracker:
    """Greedy IoU tracker with optional depth-based point matching."""

    def __init__(self, iou2d_threshold: float = 0.3, iou3d_threshold: float = 0.2,
                 track_threshold: float = 0.6, max_gap: int = 5,
                 max_points: int = 1000):
        self.iou2d_threshold = iou2d_threshold
        self.iou3d_threshold = iou3d_threshold
        self.track_threshold = track_threshold
        self.max_gap = max_gap
        self.max_points = max_points
        self.tracks: list[HeuristicTrack] = []
        self.inactive: set[int] = set()

    # ------------------------------------------------------------- helpers
    def _det_row(self, det: dict, frame_id: int, T_wc: np.ndarray) -> np.ndarray:
        t_wo = T_wc[:3, :3] @ np.asarray(det["t_co"]) + T_wc[:3, 3]
        return np.array(
            [frame_id, det["cls"], *det["box"], *det["dims"], *t_wo,
             det.get("angle", 0.0), det["score"]]
        )

    def _lift_points(self, box: np.ndarray, keypoints: np.ndarray,
                     depth_map: np.ndarray, K_depth: np.ndarray,
                     img_shape, T_wc: np.ndarray) -> np.ndarray | None:
        inb = (
            (keypoints[:, 0] > box[0]) & (keypoints[:, 0] < box[2])
            & (keypoints[:, 1] > box[1]) & (keypoints[:, 1] < box[3])
        )
        kps = keypoints[inb].copy()
        if len(kps) == 0:
            return None
        kps[:, 0] *= depth_map.shape[1] / img_shape[1]
        kps[:, 1] *= depth_map.shape[0] / img_shape[0]
        idx = kps.astype(np.int64)
        d = depth_map[np.clip(idx[:, 1], 0, depth_map.shape[0] - 1),
                      np.clip(idx[:, 0], 0, depth_map.shape[1] - 1)]
        ok = d > 0.1
        if not ok.any():
            return None
        kps, d = kps[ok], d[ok]
        rays = np.stack(
            [(kps[:, 0] - K_depth[0, 2]) / K_depth[0, 0],
             (kps[:, 1] - K_depth[1, 2]) / K_depth[1, 1],
             np.ones(len(kps))], axis=1,
        )
        pts_c = rays * d[:, None]
        return pts_c @ T_wc[:3, :3].T + T_wc[:3, 3]

    # ---------------------------------------------------------------- step
    def step(self, detections: list[dict], frame_id: int, T_wc: np.ndarray,
             img: np.ndarray | None = None, depth_map: np.ndarray | None = None,
             K_depth: np.ndarray | None = None) -> None:
        """Process one frame.

        Each detection dict: cls, box [4] xyxy px, dims [3], t_co [3],
        score, angle (optional).
        """
        used_dets: set[int] = set()
        have_depth = depth_map is not None and K_depth is not None and img is not None
        keypoints = detect_keypoints(img) if have_depth else None

        # 1. point-containment matching via linear assignment (when depth).
        if have_depth and self.tracks:
            self._match_by_points(detections, frame_id, T_wc, used_dets, img.shape)
        # 2. greedy IoU matching (run_tracking.py:106-170).
        self._match_by_iou(detections, frame_id, T_wc, used_dets)
        # 3. spawn new tracks from confident unmatched detections.
        for det_id, det in enumerate(detections):
            if det_id in used_dets or det["score"] < self.track_threshold:
                continue
            tr = HeuristicTrack(track_id=len(self.tracks))
            tr.rows.append(self._det_row(det, frame_id, T_wc))
            if have_depth:
                tr.points = self._lift_points(
                    np.asarray(det["box"]), keypoints, depth_map, K_depth,
                    img.shape, T_wc,
                )
            self.tracks.append(tr)
        # 4. deactivate stale tracks (run_tracking.py:245-248).
        for track_id, tr in enumerate(self.tracks):
            if frame_id - tr.last[0] > self.max_gap:
                self.inactive.add(track_id)

    def _match_by_iou(self, detections, frame_id, T_wc, used_dets):
        order = np.argsort([-d["score"] for d in detections])
        used_tracks: set[int] = set()
        for det_id in order:
            if det_id in used_dets:
                continue
            det = detections[det_id]
            row = self._det_row(det, frame_id, T_wc)
            best, best2d, best3d = -1, -1.0, -1.0
            for track_id, tr in enumerate(self.tracks):
                if track_id in used_tracks or tr.last[1] != det["cls"]:
                    continue
                recent = frame_id - tr.last[0] <= self.max_gap
                i3 = _iou_3d_aabb(row[9:12], row[6:9], tr.mean_t(), tr.mean_dims())
                if recent:
                    i2 = _iou_2d(row[2:6], np.asarray(tr.last[2:6]))
                    if i2 > best2d and i3 > best3d:
                        best, best2d, best3d = track_id, i2, i3
                elif i3 > best3d:
                    best, best3d = track_id, i3
            if best >= 0 and (best2d > self.iou2d_threshold or best3d > self.iou3d_threshold):
                self.tracks[best].rows.append(row)
                used_dets.add(det_id)
                used_tracks.add(best)

    def _match_by_points(self, detections, frame_id, T_wc, used_dets, img_shape):
        import scipy.optimize

        n_det, n_trk = len(detections), len(self.tracks)
        if n_det == 0 or n_trk == 0:
            return
        T_cw = np.linalg.inv(T_wc)
        cost = np.full((n_det, n_trk), 100.0)
        for det_id, det in enumerate(detections):
            box = np.asarray(det["box"])
            for track_id, tr in enumerate(self.tracks):
                if tr.points is None or tr.last[1] != det["cls"]:
                    continue
                pts_c = tr.points @ T_cw[:3, :3].T + T_cw[:3, 3]
                front = pts_c[:, 2] > 0.1
                if not front.any():
                    continue
                # no K: normalized coordinates, as the reference (module docstring)
                uv = pts_c[front, :2] / pts_c[front, 2:]
                # containment of the projected cloud in the detection box
                # (run_tracking.py:199-210): cost = 1 - inlier fraction.
                inb = (
                    (uv[:, 0] > box[0]) & (uv[:, 0] < box[2])
                    & (uv[:, 1] > box[1]) & (uv[:, 1] < box[3])
                )
                c = 1.0 - inb.mean()
                if c <= 0.2:
                    cost[det_id, track_id] = c
        rows, cols = scipy.optimize.linear_sum_assignment(cost)
        for r, c in zip(rows, cols):
            if cost[r, c] > 1.0:
                continue
            self.tracks[c].rows.append(
                self._det_row(detections[r], frame_id, T_wc)
            )
            used_dets.add(r)

    # ------------------------------------------------------------- results
    def export_tracks(self) -> list[np.ndarray]:
        return [np.stack(t.rows) for t in self.tracks if t.rows]
