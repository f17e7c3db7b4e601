"""ScanNet / Scan2CAD file-format IO (host-side, NumPy only): the scene index,
the pose, intrinsic and axis-align readers, ``make_M_from_tqs`` and
``get_cam_azi``, copied
from ``odam_tpu/data/scannet.py``.  Pure functions over the standard ScanNet
scene directory layout:

    scans/<scene_id>/
        <scene_id>.txt                 # meta incl. axisAlignment
        frames/color/<frame>.jpg
        frames/pose/<frame>.txt        # T_ws (camera-to-world-ish; see below)
        frames/intrinsic/intrinsic_color.txt
"""
from __future__ import annotations

import os

import numpy as np


def read_matrix_file(path: str) -> np.ndarray:
    with open(path, "r") as f:
        return np.asarray(
            [[float(x) for x in line.split()] for line in f.read().splitlines() if line.strip()]
        )


def read_intrinsic(path: str) -> np.ndarray:
    """[4, 4] (or [3, 3]) intrinsic matrix (scannet_utils.py:132-137)."""
    return read_matrix_file(path)


def read_extrinsic(path: str) -> np.ndarray:
    """Read a pose file and return its INVERSE, i.e. T_cw.

    The reference inverts the pose file on read (scannet_utils.py:140-147);
    callers then invert again to get T_wc (run_processor.py:72-77).
    """
    return np.linalg.inv(read_matrix_file(path))


def read_axis_align(meta_path: str) -> np.ndarray:
    """axisAlignment matrix from the scene meta file (scannet_utils.py:72-80)."""
    with open(meta_path) as f:
        for line in f:
            if "axisAlignment" in line:
                vals = [float(x) for x in line.rstrip().strip("axisAlignment = ").split(" ")]
                return np.asarray(vals).reshape(4, 4)
    raise ValueError(f"no axisAlignment in {meta_path}")


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """[w, x, y, z] -> [3, 3] rotation (replaces the numpy-quaternion dep)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def make_M_from_tqs(t, q, s) -> np.ndarray:
    """Scan2CAD T*R*S composition (scannet_utils.py:225-235)."""
    T = np.eye(4)
    T[:3, 3] = t
    R = np.eye(4)
    R[:3, :3] = quaternion_to_matrix(q)
    S = np.eye(4)
    S[:3, :3] = np.diag(s)
    return T @ R @ S


def get_cam_azi(T_wc: np.ndarray) -> float:
    """Camera azimuth in the world frame, z-up (scannet_utils.py:213-222)."""
    fwd = T_wc[:3, :3] @ np.array([0.0, 0.0, 1.0])
    return float(np.arctan2(fwd[1], fwd[0]))


class SceneIndex:
    """Filesystem index over ScanNet scenes (replaces the reference's pickled
    ScanNetTrack file index used by run_processor.py:44-59)."""

    def __init__(self, scans_root: str, sequences: list[str] | None = None):
        self.root = scans_root
        if sequences is None:
            sequences = sorted(
                d for d in os.listdir(scans_root)
                if d.startswith("scene") and os.path.isdir(os.path.join(scans_root, d))
            )
        self.sequences = sequences

    def frame_names(self, scene: str) -> list[str]:
        color = os.path.join(self.root, scene, "frames", "color")
        return sorted(
            (os.path.splitext(f)[0] for f in os.listdir(color)),
            key=lambda s: int(s) if s.isdigit() else s,
        )

    def image_path(self, scene: str, frame: str) -> str:
        return os.path.join(self.root, scene, "frames", "color", f"{frame}.jpg")

    def pose_path(self, scene: str, frame: str) -> str:
        return os.path.join(self.root, scene, "frames", "pose", f"{frame}.txt")

    def intrinsic_path(self, scene: str) -> str:
        return os.path.join(self.root, scene, "frames", "intrinsic", "intrinsic_color.txt")

    def meta_path(self, scene: str) -> str:
        return os.path.join(self.root, scene, f"{scene}.txt")
