"""Offline associator evaluation against ground-truth tracks.

Counterpart of ``odam_tpu/eval/association.py`` (the working equivalent of
the reference's run_association.py helpers): replay ground-truth track
histories frame by frame through the associator and score the predicted
matches against identity.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..data import datasets


@dataclass
class AssociationMetrics:
    n_correct: int = 0
    n_pred_matched: int = 0
    n_gt_matched: int = 0
    n_frames: int = 0
    per_frame: list = field(default_factory=list)

    @property
    def precision(self) -> float:
        return self.n_correct / max(self.n_pred_matched, 1)

    @property
    def recall(self) -> float:
        return self.n_correct / max(self.n_gt_matched, 1)

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0


def evaluate_scene(model: torch.nn.Module, tracks: list[np.ndarray],
                   match_threshold: float = 0.1,
                   max_tracks: int = 64, max_dets: int = 30, window: int = 100,
                   T_wcs: dict | None = None,
                   img_w: float | None = None, img_h: float | None = None
                   ) -> AssociationMetrics:
    """Replay one scene's GT tracks through the associator.

    Args:
        model: an :class:`odam_torch.models.associator.Associator` (JAX's
            ``model, params`` pair), run on the device of its parameters.
        tracks: list of [n_obs, >=78] GT track arrays (identity supervision).
        T_wcs: optional {frame_id: T_wc} for camera-frame re-encoding.

    Each frame's matches come to the host in one copy.
    """
    dev = next(model.parameters()).device
    m = AssociationMetrics()
    frames = np.unique(np.concatenate([t[:, 0] for t in tracks]))
    for f in frames[1:]:
        sample = datasets.build_association_sample(
            tracks, float(f), max_tracks, max_dets, window,
            T_wc=None if T_wcs is None else T_wcs.get(int(f)),
            img_w=img_w, img_h=img_h,
        )
        if sample is None:
            continue
        inputs = [torch.from_numpy(sample[k][None]).to(dev)
                  for k in ("tracks", "track_mask", "detections", "det_mask")]
        with torch.no_grad():
            out = model(*inputs, match_threshold)
        pred = out.matches[0].cpu().numpy()

        gt_pairs = {
            (int(r), int(c))
            for r, c in sample["gt_pairs"]
            if r < max_tracks and c < max_dets
        }
        gt_match_of_det = {c: r for r, c in gt_pairs}
        n_dets = int(sample["det_mask"].sum())
        correct = pred_matched = 0
        for d in range(n_dets):
            if pred[d] >= 0:
                pred_matched += 1
                if gt_match_of_det.get(d) == pred[d]:
                    correct += 1
        m.n_correct += correct
        m.n_pred_matched += pred_matched
        m.n_gt_matched += len(gt_pairs)
        m.n_frames += 1
        m.per_frame.append((int(f), correct, pred_matched, len(gt_pairs)))
    return m
