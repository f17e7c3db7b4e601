# Frozen copy of the parts of odam_torch/utils/host_boxes.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Host-side (NumPy) oriented 3D box IoU for the merge: the
convex-hull-based ``box3d_iou`` with a pure-NumPy monotone chain for the
hull."""
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


