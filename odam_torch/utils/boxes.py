"""Box helpers: the detector's postprocess and NMS, the training matcher's
GIoU, and the min-area oriented box of the mapping stage.

Counterpart of the ``odam_tpu/utils/boxes.py`` functions those stages need;
the rest of that module waits.
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
