"""Box helpers used by the detector's postprocess and NMS.

Counterpart of the three ``odam_tpu/utils/boxes.py`` functions the online
step needs; the rest of that module waits.
"""
from __future__ import annotations

import torch


def cxcywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def pairwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of xyxy boxes: [N, 4] x [M, 4] -> ([N, M] IoU, [N, M] union)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / union, union


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
