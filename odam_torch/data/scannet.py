"""ScanNet / Scan2CAD file-format IO (host-side, NumPy only), copied from
``odam_tpu/data/scannet.py``: the class tables, the scene index, the pose,
intrinsic and axis-align readers, ``make_M_from_tqs``, ``get_cam_azi`` and
the ground-truth readers (annotations, PLY vertices, aggregation,
segmentation, instance ids).  Pure functions over the standard ScanNet
scene directory layout:

    scans/<scene_id>/
        <scene_id>.txt                 # meta incl. axisAlignment
        frames/color/<frame>.jpg
        frames/pose/<frame>.txt        # T_ws (camera-to-world-ish; see below)
        frames/intrinsic/intrinsic_color.txt
"""
from __future__ import annotations

import json
import os

import numpy as np

# 18 detector classes (scannet_utils.py:28-48)
OBJ_CLASS_IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
SEMANTIC2NAME = [
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "fridge", "shower", "toilet",
    "sink", "bath", "others",
]


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


def flip_axis(pc: np.ndarray) -> np.ndarray:
    """VoteNet depth-frame -> ScanNet camera-frame axis flip (scannet_utils.py:51-60)."""
    out = np.copy(pc)
    out[..., [0, 1, 2]] = out[..., [0, 2, 1]]
    out[..., 2] *= -1
    return out


def read_gt_annotations(path: str) -> list:
    """Per-scene GT box annotations with axis flip + corner reorder
    (scannet_utils.py:201-210)."""
    with open(path, "r") as f:
        annos = json.load(f)
    for gt in annos:
        gt[1] = flip_axis(np.asarray(gt[1]))
        gt[1] = gt[1][[4, 5, 6, 7, 0, 1, 2, 3], :]
        if gt[0] in [1, 2, 3, 4, 10]:
            gt[1][4:7, 2] = 0
    return annos


def read_ply_vertices(path: str, with_rgb: bool = False) -> np.ndarray:
    """Vertex positions (and optionally colors) from a PLY mesh.

    Minimal self-contained reader (ascii and binary_little_endian) replacing
    the reference's plyfile dependency (scannet_utils.py:100-129).
    Returns [N, 3] float32 or [N, 6] with RGB in 0-255.
    """
    _SIZES = {"char": 1, "uchar": 1, "short": 2, "ushort": 2, "int": 4,
              "uint": 4, "float": 4, "double": 8, "int8": 1, "uint8": 1,
              "int16": 2, "uint16": 2, "int32": 4, "uint32": 4,
              "float32": 4, "float64": 8}
    _NP = {"char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
           "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
           "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
           "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8"}

    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        n_verts = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_verts = int(count)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list property in vertex element unsupported")
                props.append((parts[2], parts[1]))
            elif line == "end_header":
                break

        want = ["x", "y", "z"] + (["red", "green", "blue"] if with_rgb else [])
        if fmt == "ascii":
            rows = []
            for _ in range(n_verts):
                vals = f.readline().split()
                rows.append([float(v) for v in vals[: len(props)]])
            data = np.asarray(rows)
            cols = {name: data[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + _NP[t]) for name, t in props])
            raw = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype,
                                count=n_verts)
            cols = {name: raw[name].astype(np.float64) for name, _ in props}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

        return np.stack([cols[w] for w in want], axis=1).astype(np.float32)


def read_aggregation(path: str) -> tuple[dict, dict]:
    """Instance segment groups (scannet_utils.py:150-166)."""
    with open(path) as f:
        data = json.load(f)
    object_id_to_segs: dict[int, list] = {}
    label_to_segs: dict[str, list] = {}
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1  # 1-indexed instances
        object_id_to_segs[object_id] = group["segments"]
        label_to_segs.setdefault(group["label"], []).extend(group["segments"])
    return object_id_to_segs, label_to_segs


def read_segmentation(path: str) -> tuple[dict, int]:
    """Per-vertex segment ids (scannet_utils.py:169-181)."""
    with open(path) as f:
        data = json.load(f)
    seg_indices = np.asarray(data["segIndices"])
    seg_to_verts: dict[int, list] = {}
    for seg in np.unique(seg_indices):
        seg_to_verts[int(seg)] = np.nonzero(seg_indices == seg)[0].tolist()
    return seg_to_verts, len(seg_indices)


def read_instance_vertices(seg_path: str, agg_path: str) -> np.ndarray:
    """Per-vertex instance ids, 0 = unannotated (scannet_utils.py:184-198)."""
    object_id_to_segs, _ = read_aggregation(agg_path)
    seg_to_verts, n_verts = read_segmentation(seg_path)
    instance_ids = np.zeros(n_verts, np.uint32)
    for object_id, segs in object_id_to_segs.items():
        for seg in segs:
            instance_ids[seg_to_verts.get(seg, [])] = object_id
    return instance_ids


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
