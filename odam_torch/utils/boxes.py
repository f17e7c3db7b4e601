"""Box helpers: the detector's postprocess and NMS, the training matcher's
GIoU, axis-aligned and oriented 3D box IoU, and the min-area oriented box
of the mapping stage.

Counterpart of ``odam_tpu/utils/boxes.py``.  Every function is batched
tensor code on the input's device with no host sync: the oriented 3D IoU
clips the two top faces with four fixed-size Sutherland-Hodgman passes over
a masked vertex buffer and takes the area with a masked shoelace, as JAX's
does, here over leading axes instead of under ``vmap``.
"""
from __future__ import annotations

import math

import torch

from ..ops.sampler import linspace


def cxcywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def xyxy_to_cxcywh(box: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = box.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def pairwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of xyxy boxes: [..., N, 4] x [..., M, 4] -> ([..., N, M]
    IoU, [..., N, M] union)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def pairwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / union
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull


def iou_aabb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of axis-aligned boxes given as [..., 2, D] ([min corner, max corner])."""
    lo = torch.maximum(a[..., 0, :], b[..., 0, :])
    hi = torch.minimum(a[..., 1, :], b[..., 1, :])
    inter = torch.prod((hi - lo).clamp(min=0.0), dim=-1)
    vol_a = torch.prod(a[..., 1, :] - a[..., 0, :], dim=-1)
    vol_b = torch.prod(b[..., 1, :] - b[..., 0, :], dim=-1)
    return inter / (vol_a + vol_b - inter)


def giou_aabb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalized IoU of axis-aligned boxes [..., 2, D]."""
    lo = torch.maximum(a[..., 0, :], b[..., 0, :])
    hi = torch.minimum(a[..., 1, :], b[..., 1, :])
    inter = torch.prod((hi - lo).clamp(min=0.0), dim=-1)
    vol_a = torch.prod(a[..., 1, :] - a[..., 0, :], dim=-1)
    vol_b = torch.prod(b[..., 1, :] - b[..., 0, :], dim=-1)
    union = vol_a + vol_b - inter
    hull = torch.prod(torch.maximum(a[..., 1, :], b[..., 1, :])
                      - torch.minimum(a[..., 0, :], b[..., 0, :]), dim=-1)
    return inter / union - (hull - union) / hull


def aabb_from_points(pts: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> [..., 2, 3] ([min corner, max corner])."""
    return torch.stack([pts.amin(dim=-2), pts.amax(dim=-2)], dim=-2)


MAX_CLIP_VERTS = 8


def _take(verts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """verts [..., V, 2] at vertex indices idx [..., V]."""
    return torch.gather(verts, -2, idx[..., None].expand(*idx.shape, 2))


def _clip_by_edge(verts, count, cp1, cp2):
    """One Sutherland-Hodgman pass: the masked polygons ``verts`` [..., V, 2]
    (``count`` [...] valid) clipped by the half-plane left of cp1 -> cp2
    [..., 2].  The inside test is inclusive, with a tolerance scaled by the
    operands, as JAX's; the output keeps the fixed [..., V, 2] layout."""
    V = verts.shape[-2]
    idx = torch.arange(V, device=verts.device)
    safe = count.clamp(min=1)[..., None]
    e, s = verts, _take(verts, (idx - 1 + safe) % safe)
    edge = cp2 - cp1

    def inside(p):
        rel = p - cp1[..., None, :]
        cross = edge[..., None, 0] * rel[..., 1] - edge[..., None, 1] * rel[..., 0]
        tol = 1e-6 * (torch.linalg.norm(edge, dim=-1)[..., None]
                      * torch.linalg.norm(rel, dim=-1) + 1e-12)
        return cross > -tol

    in_e, in_s = inside(e), inside(s)
    # the segment (s, e) against the clip edge's line
    dc, dp = cp1 - cp2, s - e
    n1 = (cp1[..., 0] * cp2[..., 1] - cp1[..., 1] * cp2[..., 0])[..., None]
    n2 = s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0]
    denom = dc[..., None, 0] * dp[..., 1] - dc[..., None, 1] * dp[..., 0]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    inter = torch.stack([(n1 * dp[..., 0] - n2 * dc[..., None, 0]) / denom,
                         (n1 * dp[..., 1] - n2 * dc[..., None, 1]) / denom], dim=-1)
    active = idx < count[..., None]
    # vertex i offers its crossing (slot 2i) then itself (slot 2i + 1), in order
    cand = torch.stack([inter, e], dim=-2).reshape(*verts.shape[:-2], 2 * V, 2)
    valid = torch.stack([active & (in_e != in_s), active & in_e], dim=-1).reshape(
        *verts.shape[:-2], 2 * V)
    to = torch.where(valid, torch.cumsum(valid, -1) - 1, 2 * V)      # 2V: dropped
    out = verts.new_zeros(*verts.shape[:-2], 2 * V + 1, 2).scatter(
        -2, to[..., None].expand(*to.shape, 2), cand)
    return out[..., :V, :], valid.sum(-1)


def _masked_shoelace(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Area of masked polygons [..., V, 2] with ``count`` valid vertices."""
    V = verts.shape[-2]
    idx = torch.arange(V, device=verts.device)
    nxt = _take(verts, (idx + 1) % count.clamp(min=1)[..., None])
    cross = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    cross = torch.where(idx < count[..., None], cross, 0.0)
    return 0.5 * cross.sum(-1).abs() * (count >= 3)


def convex_quad_intersection_area(quad1: torch.Tensor, quad2: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quadrilaterals [..., 4, 2] (CCW order)."""
    lead = torch.broadcast_shapes(quad1.shape[:-2], quad2.shape[:-2])
    quad1, quad2 = quad1.expand(*lead, 4, 2), quad2.expand(*lead, 4, 2)
    verts = torch.cat([quad1, quad1.new_zeros(*lead, MAX_CLIP_VERTS - 4, 2)], dim=-2)
    count = torch.full(lead, 4, dtype=torch.long, device=quad1.device)
    for k in range(4):
        verts, count = _clip_by_edge(verts, count, quad2[..., k - 1, :], quad2[..., k, :])
    return _masked_shoelace(verts, count)


def _quad_area(quad: torch.Tensor) -> torch.Tensor:
    nxt = torch.roll(quad, -1, dims=-2)
    return 0.5 * (quad[..., 0] * nxt[..., 1] - nxt[..., 0] * quad[..., 1]).sum(-1).abs()


def box3d_vol(corners: torch.Tensor) -> torch.Tensor:
    """Volume of oriented boxes from their 8 corners [..., 8, 3]."""
    a = torch.linalg.norm(corners[..., 0, :] - corners[..., 1, :], dim=-1)
    b = torch.linalg.norm(corners[..., 1, :] - corners[..., 2, :], dim=-1)
    c = torch.linalg.norm(corners[..., 0, :] - corners[..., 4, :], dim=-1)
    return a * b * c


def box3d_iou(corners1: torch.Tensor, corners2: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Oriented (z-aligned) 3D box IoU of 8-corner arrays [..., 8, 3] (top
    face first, as ``geometry.corners_from_dims``) -> (iou_3d, iou_bev)."""
    rect1 = corners1[..., [3, 2, 1, 0], :2]     # the top face reversed: counter-clockwise
    rect2 = corners2[..., [3, 2, 1, 0], :2]
    inter_area = convex_quad_intersection_area(rect1, rect2)
    iou_2d = inter_area / (_quad_area(rect1) + _quad_area(rect2) - inter_area)
    zmax = torch.minimum(corners1[..., 0, 2], corners2[..., 0, 2])
    zmin = torch.maximum(corners1[..., 4, 2], corners2[..., 4, 2])
    inter_vol = inter_area * (zmax - zmin).clamp(min=0.0)
    iou = inter_vol / (box3d_vol(corners1) + box3d_vol(corners2) - inter_vol)
    return iou, iou_2d


def pairwise_box3d_iou(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """Pairwise oriented 3D IoU: [N, 8, 3] x [M, 8, 3] -> [N, M]."""
    return box3d_iou(corners1[:, None], corners2[None, :])[0]


def xyxy_scale(img_w: float, img_h: float, device) -> torch.Tensor:
    """[w, h, w, h] float32, made on the device (no host-to-device copy)."""
    s = torch.full((4,), float(img_w), device=device)
    s[1::2] = float(img_h)
    return s


def oriented_bbox_2d_sweep(pts_xy: torch.Tensor, weights: torch.Tensor | None = None,
                           num_angles: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-area oriented rectangles of point sets by a dense angle sweep.

    Batched over the leading axis (the JAX package vmaps one set at a time):
    ``num_angles`` angles over [0, pi/2), then 65 angles over one coarse step
    either side of the winner.  The rotation is R = [[c, -s], [s, c]]
    applied as R p; the corners are [max,max], [max,min], [min,min],
    [min,max] in the rotated frame, mapped back as ``corner @ R + mean``.

    Args:
        pts_xy: [B, N, 2] points.
        weights: optional [B, N] validity (points with weight 0 are ignored).

    Returns:
        (corners [B, 4, 2], angle [B]).
    """
    if weights is None:
        weights = torch.ones(pts_xy.shape[:-1], dtype=pts_xy.dtype, device=pts_xy.device)
    wsum = torch.clamp(weights.sum(-1), min=1e-9)
    mean = (pts_xy * weights[..., None]).sum(-2) / wsum[..., None]      # [B, 2]
    centered = pts_xy - mean[:, None, :]
    valid = (weights > 0)[:, None, :]                                   # [B, 1, N]
    cx, cy = centered[:, None, :, 0], centered[:, None, :, 1]           # [B, 1, N]

    def extents(angles):                                                # [B, A] or [A]
        c, s = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
        x_rot = c * cx - s * cy                                         # [B, A, N]
        y_rot = s * cx + c * cy
        big = 1e9
        x_min = torch.where(valid, x_rot, big).amin(-1)
        x_max = torch.where(valid, x_rot, -big).amax(-1)
        y_min = torch.where(valid, y_rot, big).amin(-1)
        y_max = torch.where(valid, y_rot, -big).amax(-1)
        return (x_max - x_min) * (y_max - y_min), x_min, x_max, y_min, y_max

    dev = pts_xy.device
    coarse = linspace(0.0, math.pi / 2, num_angles, dev, endpoint=False)
    area_c, *_ = extents(coarse)
    best_c = coarse[area_c.argmin(-1)]                                  # [B]
    step = (math.pi / 2) / num_angles
    fine = best_c[:, None] + linspace(-step, step, 65, dev)             # [B, 65]
    area, x_min, x_max, y_min, y_max = extents(fine)
    best = area.argmin(-1, keepdim=True)

    def pick(v):
        return torch.gather(v, -1, best)[:, 0]

    ang = pick(fine)
    x_min, x_max, y_min, y_max = pick(x_min), pick(x_max), pick(y_min), pick(y_max)
    c, s = torch.cos(ang), torch.sin(ang)
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)      # [B, 2, 2]
    rect = torch.stack([torch.stack([x_max, y_max], -1), torch.stack([x_max, y_min], -1),
                        torch.stack([x_min, y_min], -1), torch.stack([x_min, y_max], -1)], -2)
    return rect @ R + mean[:, None, :], ang


def oriented_bbox_3d_sweep(pts: torch.Tensor, weights: torch.Tensor | None = None,
                           num_angles: int = 512) -> torch.Tensor:
    """Oriented z-up 3D boxes of point sets: [B, N, 3] -> [B, 8, 3] corners,
    the top face (z max) first."""
    if weights is None:
        weights = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    big = 1e9
    valid = weights > 0
    z_min = torch.where(valid, pts[..., 2], big).amin(-1)
    z_max = torch.where(valid, pts[..., 2], -big).amax(-1)
    corners_2d, _ = oriented_bbox_2d_sweep(pts[..., :2], weights, num_angles)
    top = torch.cat([corners_2d, z_max[:, None, None].expand(-1, 4, 1)], dim=-1)
    bot = torch.cat([corners_2d, z_min[:, None, None].expand(-1, 4, 1)], dim=-1)
    return torch.cat([top, bot], dim=-2)
