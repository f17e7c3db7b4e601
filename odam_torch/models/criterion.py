"""DETR set-prediction training losses.

Counterpart of ``odam_tpu/models/criterion.py``: cross-entropy with the
no-object weight, the cardinality error (logging only, no gradient), box L1
and GIoU, size / offset / depth L1, the angle-bin CE, the focal and dice
mask losses, and the per-decoder-layer auxiliary losses, all normalised by
the batch's target count.  Losses are taken in float32 whatever the
model's compute dtype (in float64 for a float64 reference model).

JAX takes the loss over the global batch, sharded or not, so its
normalizers are global.  With a process group (``group``: each rank holds
its rows of the global batch), the port all-reduces them before any
division: the target count ``num_boxes``, each layer's cross-entropy weight
sum and its image count (the cardinality error's mean).  Each rank's loss
is then its own numerator over the global denominator, its share: the
shares sum over the ranks to the global loss, and their gradients to the
global gradient (:mod:`odam_torch.models.training` sums them).

The matches come from :class:`odam_torch.models.matcher.HungarianMatcher`
(one LAP launch for all prediction sets, no host read), or are passed in: a seeded model's
queries can score within rounding of each other, and then a test holds two
implementations to the same match.

Padded target layout (:class:`Targets`):
    classes [B, M] int | boxes [B, M, 4] cxcywh | sizes [B, M, 3] |
    offsets [B, M, 2] | depths [B, M] | angle_bins [B, M] int | mask [B, M].
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.distributed import all_reduce_sum
from ..utils import boxes as box_ops
from . import matcher as matcher_mod
from .layers import at_least_f32


class Targets(NamedTuple):
    classes: torch.Tensor
    boxes: torch.Tensor
    sizes: torch.Tensor
    offsets: torch.Tensor
    depths: torch.Tensor
    angle_bins: torch.Tensor
    mask: torch.Tensor


@dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 18
    eos_coef: float = 0.1
    matcher: matcher_mod.MatcherConfig = field(default_factory=matcher_mod.MatcherConfig)
    weight_ce: float = 1.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    weight_angle: float = 1.0
    weight_offset: float = 3.0
    weight_size: float = 1.0
    weight_depth: float = 1.0
    weight_mask: float = 1.0
    weight_dice: float = 1.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


def _gather_targets(t: torch.Tensor, tgt4query: torch.Tensor) -> torch.Tensor:
    """Per-query matched target values [B, M, ...] -> [B, Q, ...]; index -1
    takes target 0 (masked out later)."""
    idx = tgt4query.long().clamp(0, t.shape[1] - 1)
    idx = idx.reshape(idx.shape + (1,) * (t.ndim - 2)).expand(*idx.shape, *t.shape[2:])
    return torch.gather(t, 1, idx)


def _paired_giou(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """GIoU of matching xyxy boxes [..., 4] -> [...]: the diagonal of
    :func:`box_ops.pairwise_generalized_box_iou`, in the same arithmetic."""
    area1, area2 = box_ops.box_area(p), box_ops.box_area(t)
    wh = (torch.minimum(p[..., 2:], t[..., 2:]) - torch.maximum(p[..., :2], t[..., :2])
          ).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    wh = (torch.maximum(p[..., 2:], t[..., 2:]) - torch.minimum(p[..., :2], t[..., :2])
          ).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    return inter / union - (hull - union) / hull


def _nll(logits: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, index.long()[..., None])[..., 0]


def layer_losses(outputs: dict, targets: Targets, tgt4query: torch.Tensor,
                 num_boxes: torch.Tensor, cfg: CriterionConfig, group=None
                 ) -> dict[str, torch.Tensor]:
    """All losses for one prediction set (one decoder layer).  With a
    ``group``, ``num_boxes`` must be the global count, and the
    cross-entropy's weight sum and the cardinality error's image count are
    all-reduced here (in one collective): each loss is this rank's share."""
    out = {k: at_least_f32(v) for k, v in outputs.items() if k.startswith("pred_")}
    matched = tgt4query >= 0
    m = matched.float()

    tgt_cls = torch.where(matched, _gather_targets(targets.classes, tgt4query).long(),
                          cfg.num_classes)
    nll = _nll(out["pred_logits"], tgt_cls)
    w = torch.where(matched, 1.0, cfg.eos_coef)

    with torch.no_grad():
        probs = torch.softmax(out["pred_logits"], dim=-1)[..., :-1]
        card_pred = (probs.amax(-1) > 0.7).float().sum(1)
        card_err = (card_pred - targets.mask.float().sum(1)).abs()
    if group is None:
        loss_ce = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        cardinality = card_err.mean()
    else:
        w_sum, n_images = all_reduce_sum(torch.stack([w.sum(), w.new_full((), len(w))]), group)
        loss_ce = (nll * w).sum() / torch.clamp(w_sum, min=1.0)
        cardinality = card_err.sum() / n_images

    def matched_l1(pred, tgt_field):
        tgt = _gather_targets(tgt_field, tgt4query)
        l1 = (pred - tgt).abs().sum(-1) if pred.ndim == 3 else (pred - tgt).abs()
        return (l1 * m).sum() / num_boxes

    tgt_boxes = _gather_targets(targets.boxes, tgt4query)
    giou = _paired_giou(box_ops.cxcywh_to_xyxy(out["pred_boxes"]),
                        box_ops.cxcywh_to_xyxy(tgt_boxes))
    n_bins = out["pred_angle"].shape[-1]
    tgt_angle = _gather_targets(targets.angle_bins, tgt4query).long().clamp(0, n_bins - 1)
    return {
        "loss_ce": loss_ce,
        "loss_bbox": matched_l1(out["pred_boxes"], targets.boxes),
        "loss_giou": ((1.0 - giou) * m).sum() / num_boxes,
        "loss_size": matched_l1(out["pred_size"], targets.sizes),
        "loss_offset": matched_l1(out["pred_offset"], targets.offsets),
        "loss_depth": matched_l1(out["pred_depth"][..., 0], targets.depths),
        "loss_angle": (_nll(out["pred_angle"], tgt_angle) * m).sum() / num_boxes,
        "cardinality_error": cardinality,
    }


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
                       num_boxes: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-pixel focal loss of [K, P] mask logits, averaged per mask, summed
    over the valid rows and normalised by ``num_boxes``."""
    prob = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return (loss.mean(-1) * valid.to(loss.dtype)).sum() / num_boxes


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
              num_boxes: torch.Tensor) -> torch.Tensor:
    """Soft-dice loss over [K, P] flattened masks."""
    inputs = torch.sigmoid(logits)
    numerator = 2.0 * (inputs * targets).sum(-1)
    denominator = inputs.sum(-1) + targets.sum(-1)
    per_mask = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    return (per_mask * valid.to(per_mask.dtype)).sum() / num_boxes


def loss_masks(pred_masks: torch.Tensor, target_masks: torch.Tensor, tgt4query: torch.Tensor,
               num_boxes: torch.Tensor, cfg: CriterionConfig = CriterionConfig()) -> dict:
    """Focal + dice losses of predicted masks [B, Q, h, w] against target
    masks [B, M, H, W] over the matched pairs.  The predictions are resized
    bilinearly (half-pixel centres) to H x W, antialiased when that
    shrinks them, as ``jax.image.resize`` does."""
    B, Q, h, w = pred_masks.shape
    H, W = target_masks.shape[-2:]
    up = F.interpolate(pred_masks.float(), size=(H, W), mode="bilinear", align_corners=False,
                       antialias=H < h or W < w)
    tgt = _gather_targets(target_masks, tgt4query)
    valid = (tgt4query >= 0).reshape(B * Q)
    logits = up.reshape(B * Q, H * W)
    targets = tgt.reshape(B * Q, H * W).float()
    return {
        "loss_mask": sigmoid_focal_loss(logits, targets, valid, num_boxes,
                                        cfg.focal_alpha, cfg.focal_gamma),
        "loss_dice": dice_loss(logits, targets, valid, num_boxes),
    }


def weighted_total(losses: dict[str, torch.Tensor], cfg: CriterionConfig) -> torch.Tensor:
    return (
        cfg.weight_ce * losses["loss_ce"]
        + cfg.weight_bbox * losses["loss_bbox"]
        + cfg.weight_giou * losses["loss_giou"]
        + cfg.weight_size * losses["loss_size"]
        + cfg.weight_offset * losses["loss_offset"]
        + cfg.weight_depth * losses["loss_depth"]
        + cfg.weight_angle * losses["loss_angle"]
    )


def set_criterion(outputs: dict, targets: Targets, cfg: CriterionConfig = CriterionConfig(),
                  target_masks: torch.Tensor | None = None,
                  matches: list[torch.Tensor] | None = None,
                  matcher: matcher_mod.HungarianMatcher | None = None, group=None
                  ) -> tuple[torch.Tensor, dict]:
    """Total weighted loss over the final and aux layers -> (scalar, metrics).

    ``matches``: one tgt4query [B, Q] per prediction set (the final layer's,
    then each aux layer's); without it ``matcher`` (or a new one with
    ``cfg.matcher``) computes them.  With ``target_masks`` [B, M, H, W] and
    ``pred_masks`` in ``outputs``, the focal and dice losses of the final
    layer are added.  ``group``: the process group over which the batch
    is sharded (module docstring); the returned values are then this rank's
    shares.
    """
    num_boxes = targets.mask.float().sum()
    if group is not None:
        num_boxes = all_reduce_sum(num_boxes, group)
    num_boxes = torch.clamp(num_boxes, min=1.0)
    aux = outputs.get("aux_outputs", [])
    if matches is None:
        matcher = matcher or matcher_mod.HungarianMatcher(cfg.matcher)
        matches = matcher([outputs, *aux], targets.classes, targets.boxes, targets.mask)
    losses = layer_losses(outputs, targets, matches[0], num_boxes, cfg, group)
    total = weighted_total(losses, cfg)
    metrics = dict(losses)
    if target_masks is not None and "pred_masks" in outputs:
        mlosses = loss_masks(outputs["pred_masks"], target_masks, matches[0], num_boxes, cfg)
        total = (total + cfg.weight_mask * mlosses["loss_mask"]
                 + cfg.weight_dice * mlosses["loss_dice"])
        metrics.update(mlosses)
    for i, aux_out in enumerate(aux):
        aux_losses = layer_losses(aux_out, targets, matches[i + 1], num_boxes, cfg, group)
        total = total + weighted_total(aux_losses, cfg)
        metrics.update({f"{k}_{i}": v for k, v in aux_losses.items()
                        if k != "cardinality_error"})
    metrics["total"] = total
    return total, metrics
