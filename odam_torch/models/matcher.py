"""Hungarian set matcher for DETR training.

Counterpart of ``odam_tpu/models/matcher.py``: cost = 5 * L1(box) + 1 *
(-prob[class]) + 2 * (-GIoU), solved per image as a linear assignment on
the device inside the train step, as in the JAX package.  The cost matrices
of the final decoder layer and every auxiliary one are stacked, and all
(aux + 1) x B assignments go to :func:`odam_torch.ops.lap.masked_assignment`
at once: one launch of the LAP kernel a step, with no host read
(:class:`HungarianMatcher`).  With Q queries above M targets that is its
transposed branch.

Targets are padded: ``classes`` [B, M] int, ``boxes`` [B, M, 4] cxcywh,
``mask`` [B, M] validity.  A match ``tgt4query`` [B, Q] is int32: the target
index per query, -1 where the query is unmatched.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import lap
from ..utils import boxes as box_ops


@dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0


def match_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, tgt_classes: torch.Tensor,
               tgt_boxes: torch.Tensor, cfg: MatcherConfig = MatcherConfig()) -> torch.Tensor:
    """Matching cost [..., Q, M] of predictions [..., Q, C+1] / [..., Q, 4]
    against targets [..., M] / [..., M, 4], in float32."""
    prob = torch.softmax(pred_logits.float(), dim=-1)
    idx = tgt_classes.long().clamp(0, prob.shape[-1] - 1)
    idx = idx.unsqueeze(-2).expand(*prob.shape[:-1], idx.shape[-1])
    cost_class = -torch.gather(prob, -1, idx)
    pred_boxes, tgt_boxes = pred_boxes.float(), tgt_boxes.float()
    cost_bbox = (pred_boxes.unsqueeze(-2) - tgt_boxes.unsqueeze(-3)).abs().sum(-1)
    cost_giou = -box_ops.pairwise_generalized_box_iou(
        box_ops.cxcywh_to_xyxy(pred_boxes), box_ops.cxcywh_to_xyxy(tgt_boxes))
    return cfg.cost_bbox * cost_bbox + cfg.cost_class * cost_class + cfg.cost_giou * cost_giou


class HungarianMatcher:
    """Matches every prediction set of a step in one batched solve."""

    def __init__(self, cfg: MatcherConfig = MatcherConfig()):
        self.cfg = cfg

    @torch.no_grad()
    def __call__(self, sets: list[dict], tgt_classes: torch.Tensor, tgt_boxes: torch.Tensor,
                 tgt_mask: torch.Tensor) -> list[torch.Tensor]:
        """``sets``: prediction dicts (``pred_logits``, ``pred_boxes``), the
        final layer's then the aux layers' -> one tgt4query [B, Q] per set,
        on the predictions' device."""
        cost = torch.stack([match_cost(s["pred_logits"], s["pred_boxes"], tgt_classes,
                                       tgt_boxes, self.cfg) for s in sets])     # [S, B, Q, M]
        S, B, Q, _ = cost.shape
        rows = torch.ones((S, B, Q), dtype=torch.bool, device=cost.device)
        cols = tgt_mask.bool().expand(S, *tgt_mask.shape)
        return list(lap.masked_assignment(cost, rows, cols).unbind(0))


def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_classes: torch.Tensor, tgt_boxes: torch.Tensor, tgt_mask: torch.Tensor,
                    cfg: MatcherConfig = MatcherConfig()) -> torch.Tensor:
    """One prediction set -> tgt4query [B, Q] int32 (target per query, -1)."""
    sets = [{"pred_logits": pred_logits, "pred_boxes": pred_boxes}]
    return HungarianMatcher(cfg)(sets, tgt_classes, tgt_boxes, tgt_mask)[0]
