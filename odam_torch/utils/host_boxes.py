"""Host-side (NumPy) exact oriented-box IoU for the evaluation protocol and
the merge: the convex-hull-based ``box3d_iou`` of the reference
(box_utils.py:97-120), copied from ``odam_tpu/utils/host_boxes.py``, with a
pure-NumPy monotone chain for the hull; and ``robust_box3d_iou``, the same
IoU with a clip that stays well-defined for boxes that nearly coincide.
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
