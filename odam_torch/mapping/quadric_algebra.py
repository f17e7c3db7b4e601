"""Quadric/plane vectorization algebra and the SVD quadric initializer.

Capability parity with the reference's quadric helpers
(src/super_quadric/quadric_helper.py and sq_libs.py:30-36): the symmetric
4x4 dual quadric <-> 10-vector packing, the plane -> rank-1 constraint
vector map (each tangent plane pi of a dual quadric Q satisfies
pi^T Q pi = 0, linear in the 10-vector), box-edge line extraction, plane
construction, and the least-squares (smallest-singular-vector) quadric
initialization from a stack of tangent-plane constraints.

NumPy host-side (used during constraint setup); shapes are tiny.  A copy
of ``odam_tpu/mapping/quadric_algebra.py``.
"""
from __future__ import annotations

import numpy as np

# Index pairs of the upper triangle of a symmetric 4x4 in pack order
# (quadric_helper.py:4-36).
_UT = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (3, 3)]


def quadric_to_vector(Q: np.ndarray) -> np.ndarray:
    """Symmetric [4, 4] -> [10] upper-triangle packing."""
    Q = np.asarray(Q)
    return np.array([Q[i, j] for i, j in _UT])


def vector_to_quadric(v: np.ndarray) -> np.ndarray:
    """[10] -> symmetric [4, 4]."""
    Q = np.zeros((4, 4))
    for k, (i, j) in enumerate(_UT):
        Q[i, j] = v[k]
        Q[j, i] = v[k]
    return Q


def plane_constraint_vector(plane: np.ndarray) -> np.ndarray:
    """Tangent plane [4] -> [10] row such that row . vec(Q) = pi^T Q pi.

    Off-diagonal entries are doubled because vec(Q) stores each symmetric
    pair once (quadric_helper.py:39-48).
    """
    p = np.asarray(plane, np.float64)
    out = []
    for i, j in _UT:
        c = p[i] * p[j]
        out.append(c if i == j else 2 * c)
    return np.asarray(out)


def normalize_plane(plane: np.ndarray) -> np.ndarray:
    """Scale so the normal part has unit norm (quadric_helper.py:61-66)."""
    plane = np.asarray(plane, np.float64)
    return plane / np.linalg.norm(plane[..., :3], axis=-1, keepdims=True)


def bbox_edge_lines(bbox_xyxy: np.ndarray, img_h: float | None = None,
                    img_w: float | None = None,
                    edge_threshold: float | None = None) -> dict[str, np.ndarray]:
    """2D box -> image-line equations per edge, optionally border-filtered.

    Lines are (a, b, c) with a x + b y + c = 0: x-edges (1, 0, -x), y-edges
    (0, 1, -y).  Reference behavior: quadric_helper.py:69-109.
    """
    x0, y0, x1, y1 = np.asarray(bbox_xyxy).ravel()
    entries = {
        "x_min": (x0, np.array([1.0, 0.0, -x0]), "x"),
        "y_min": (y0, np.array([0.0, 1.0, -y0]), "y"),
        "x_max": (x1, np.array([1.0, 0.0, -x1]), "x"),
        "y_max": (y1, np.array([0.0, 1.0, -y1]), "y"),
    }
    out = {}
    for name, (value, line, axis) in entries.items():
        if edge_threshold is not None:
            hi = img_w if axis == "x" else img_h
            if not (edge_threshold < value < hi - edge_threshold):
                continue
        out[name] = line
    return out


def backproject_line_to_plane(line: np.ndarray, P_cw: np.ndarray) -> np.ndarray:
    """Image line [3] + projection [3, 4] -> world plane [4] (pi = P^T l)."""
    return normalize_plane(np.asarray(line) @ np.asarray(P_cw))


def depth_bound_planes(pts_w: np.ndarray, T_wc: np.ndarray) -> list[np.ndarray]:
    """Min/max-depth world planes bounding a point set from one camera.

    Reference behavior: tracking_gt_utils.py:16-31 (get_depth_planes).
    """
    T_cw = np.linalg.inv(T_wc)
    pts_c = (np.concatenate([pts_w, np.ones_like(pts_w[:, :1])], 1) @ T_cw.T)[:, :3]
    out = []
    for depth in (pts_c[:, 2].min(), pts_c[:, 2].max()):
        plane_c = np.array([0.0, 0.0, -1.0, depth])
        plane_w = normalize_plane(T_cw.T @ plane_c)
        out.append(plane_w)
    return out


def quadric_from_planes_svd(planes: list[np.ndarray]) -> np.ndarray:
    """Least-squares dual quadric from tangent planes.

    Stacks the rank-1 constraint rows and takes the singular vector of the
    smallest singular value (the reference's eigen variant, sq_libs.py:30-36,
    via SVD for numerical symmetry).

    Returns:
        [4, 4] symmetric dual quadric (unnormalized scale).
    """
    A = np.stack([plane_constraint_vector(p) for p in planes])
    _, _, vt = np.linalg.svd(A, full_matrices=True)
    return vector_to_quadric(vt[-1])


def aabb_face_planes(corners: np.ndarray) -> list[np.ndarray]:
    """Six face planes of an 8-corner box (quadric_helper.py:123-186).

    Corner convention: top face (+z) first, as produced by
    odam_tpu.utils.geometry.corners_from_dims.
    """
    faces = [
        (0, 1, 4), (1, 2, 6), (2, 3, 6), (0, 3, 7), (4, 5, 6), (0, 1, 2)
    ]
    planes = []
    for i, j, k in faces:
        v1 = corners[i] - corners[j]
        v2 = corners[i] - corners[k]
        n = np.cross(v1, v2)
        n = n / np.linalg.norm(n)
        planes.append(np.array([n[0], n[1], n[2], -corners[i] @ n]))
    return planes
