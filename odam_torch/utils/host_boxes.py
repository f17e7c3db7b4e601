"""Host-side (NumPy) exact oriented boxes for the evaluation protocol and
the merge, copied from ``odam_tpu/utils/host_boxes.py``: the min-area
rectangle on the convex hull's edge angles (``min_area_rect``,
``oriented_bbox_3d``, ``bbox_and_orientation``; reference box_utils.py:
169-283, 319-410), the convex-hull-based ``box3d_iou`` (box_utils.py:
97-120), with a pure-NumPy monotone chain for the hull; and
``robust_box3d_iou``, the same IoU with a clip that stays well-defined for
boxes that nearly coincide.
"""
from __future__ import annotations

import numpy as np


def convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Counter-clockwise convex hull of [N, 2] points (Andrew's monotone chain)."""
    pts = np.asarray(pts, dtype=np.float64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]
    # de-duplicate
    keep = np.ones(len(pts), dtype=bool)
    keep[1:] = np.any(np.diff(pts, axis=0) != 0, axis=1)
    pts = pts[keep]
    if len(pts) <= 2:
        return pts

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2:
                o, a = out[-2], out[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) - (a[1] - o[1]) * (p[0] - o[0]) <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def min_area_rect(pts_xy: np.ndarray) -> tuple[np.ndarray, float]:
    """Exact min-area oriented rectangle via hull-edge angles.

    Mirrors the reference algorithm (box_utils.py:169-255): center the hull,
    reduce edge angles mod pi/2, test each candidate, reconstruct corners with
    the row-vector convention ``corner = [x, y] @ R``.

    Returns:
        (corners [4, 2], angle).
    """
    hull = convex_hull_2d(np.asarray(pts_xy, dtype=np.float64))
    mean = hull.mean(axis=0)
    h = hull - mean

    # All hull edges including the closing one (the reference drops the
    # closing edge, box_utils.py:187-191 — an off-by-one this fixes).
    edges = np.diff(np.vstack([h, h[:1]]), axis=0)
    if len(h) < 2:
        corners = np.tile(mean, (4, 1))
        return corners, 0.0
    angles = np.abs(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2))
    angles = np.unique(angles)

    best = None
    for ang in angles:
        c, s = np.cos(ang), np.sin(ang)
        # Reference rotation convention (box_utils.py:212-217): R rotates by
        # -ang, aligning a hull edge at angle ``ang`` with the x-axis.
        R = np.array([[c, s], [-s, c]])
        rot = R @ h.T
        x_min, x_max = rot[0].min(), rot[0].max()
        y_min, y_max = rot[1].min(), rot[1].max()
        area = (x_max - x_min) * (y_max - y_min)
        if best is None or area < best[0]:
            best = (area, ang, x_min, x_max, y_min, y_max)

    _, ang, x_min, x_max, y_min, y_max = best
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, s], [-s, c]])
    rect = np.array(
        [[x_max, y_max], [x_max, y_min], [x_min, y_min], [x_min, y_max]]
    )
    corners = rect @ R + mean  # row-vector form: the inverse (+ang) rotation
    return corners, float(ang)


def oriented_bbox_3d(pts: np.ndarray) -> np.ndarray:
    """Exact oriented 3D box (z-up) from points: [N, 3] -> [8, 3] corners.

    Top face (z_max) first — reference: box_utils.py:319-410 (compute_oriented_bbox).
    """
    pts = np.asarray(pts, dtype=np.float64)
    z_min, z_max = pts[:, 2].min(), pts[:, 2].max()
    corners_2d, _ = min_area_rect(pts[:, :2])
    top = np.concatenate([corners_2d, np.full((4, 1), z_max)], axis=1)
    bot = np.concatenate([corners_2d, np.full((4, 1), z_min)], axis=1)
    return np.concatenate([top, bot], axis=0)


def bbox_and_orientation(vertices: np.ndarray) -> tuple[np.ndarray, float]:
    """Oriented 3D box + long-axis orientation (reference: box_utils.py:258-283)."""
    corners = oriented_bbox_3d(vertices)
    bbox_2d = corners[:4, :2]
    axis1 = np.linalg.norm(bbox_2d[0] - bbox_2d[1])
    axis2 = np.linalg.norm(bbox_2d[0] - bbox_2d[3])
    long_axis = bbox_2d[0] - (bbox_2d[1] if axis1 > axis2 else bbox_2d[3])
    long_axis = long_axis / np.linalg.norm(long_axis)
    theta = float(np.arccos(np.clip(long_axis @ np.array([1.0, 0.0]), -1.0, 1.0)))
    return corners, theta


def polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(x @ np.roll(y, 1) - y @ np.roll(x, 1)))


def polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray | None:
    """Sutherland–Hodgman clip of polygon ``subject`` by convex CCW ``clip``.

    Host-exact equivalent of box_utils.py:24-67.
    """
    output = [tuple(p) for p in subject]
    cp1 = tuple(clip[-1])
    for cp2 in map(tuple, clip):
        if not output:
            return None
        input_list, output = output, []
        s = input_list[-1]

        def inside(p):
            return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) > (cp2[1] - cp1[1]) * (p[0] - cp1[0])

        def intersect(s, e):
            dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
            dp = (s[0] - e[0], s[1] - e[1])
            n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
            n2 = s[0] * e[1] - s[1] * e[0]
            n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
            return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)

        for e in input_list:
            if inside(e):
                if not inside(s):
                    output.append(intersect(s, e))
                output.append(e)
            elif inside(s):
                output.append(intersect(s, e))
            s = e
        cp1 = cp2
    return np.asarray(output) if output else None


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray) -> tuple[float, float]:
    """Exact oriented 3D IoU from 8-corner arrays (reference: box_utils.py:97-120)."""
    rect1 = corners1[3::-1, :2]
    rect2 = corners2[3::-1, :2]
    area1 = polygon_area(rect1)
    area2 = polygon_area(rect2)
    inter = polygon_clip(rect1, rect2)
    inter_area = polygon_area(convex_hull_2d(inter)) if inter is not None and len(inter) >= 3 else 0.0
    iou_2d = inter_area / (area1 + area2 - inter_area)
    zmax = min(corners1[0, 2], corners2[0, 2])
    zmin = max(corners1[4, 2], corners2[4, 2])
    inter_vol = inter_area * max(0.0, zmax - zmin)

    def vol(c):
        a = np.linalg.norm(c[0] - c[1])
        b = np.linalg.norm(c[1] - c[2])
        h = np.linalg.norm(c[0] - c[4])
        return a * b * h

    iou = inter_vol / (vol(corners1) + vol(corners2) - inter_vol)
    return float(iou), float(iou_2d)


def robust_box3d_iou(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """Oriented 3D IoU of two 8-corner boxes (top face first), for comparing
    two runs' boxes.

    ``box3d_iou`` clips with a strict inside test and intersects edges as
    lines, which is degenerate for boxes that nearly coincide (it gives
    1.0023, 1.0176 or NaN for boxes a few ulps apart); this clip
    interpolates along each edge instead and stays in [0, 1].
    """
    a, b = np.asarray(corners1, np.float64), np.asarray(corners2, np.float64)

    def area(p):
        return 0.5 * float(p[:, 0] @ np.roll(p[:, 1], -1) - p[:, 1] @ np.roll(p[:, 0], -1))

    pa, pb = (p if area(p) > 0 else p[::-1] for p in (a[:4, :2], b[:4, :2]))
    out = list(pa)
    for i in range(4):
        c0, c1 = pb[i], pb[(i + 1) % 4]
        src, out = out, []
        for j in range(len(src)):
            s, e = src[j - 1], src[j]
            ds = (c1[0] - c0[0]) * (s[1] - c0[1]) - (c1[1] - c0[1]) * (s[0] - c0[0])
            de = (c1[0] - c0[0]) * (e[1] - c0[1]) - (c1[1] - c0[1]) * (e[0] - c0[0])
            if (ds < 0) != (de < 0):
                out.append(s + (e - s) * (ds / (ds - de)))
            if de >= 0:
                out.append(e)
        if not out:
            return 0.0
    inter = area(np.asarray(out)) * max(0.0, min(a[0, 2], b[0, 2]) - max(a[4, 2], b[4, 2]))
    vol_a, vol_b = (abs(area(c[:4, :2])) * (c[0, 2] - c[4, 2]) for c in (a, b))
    return float(inter / (vol_a + vol_b - inter))
