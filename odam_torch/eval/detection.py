"""Detection mAP and Scan2CAD alignment-accuracy metrics (host NumPy).

Counterpart of ``odam_tpu/eval/detection.py`` (the reference's
src/utils/eval_utils.py): VOC-style average precision over 3D AABB IoU per
class, and the Scan2CAD alignment-accuracy criterion (translation <= 0.2 m,
rotation <= 20 deg, scale ratio <= 20 %, or IoU > 0.5; eval_utils.py:318-320,
383-384).  ``eval_det``'s worker pool starts its processes with ``spawn``.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """VOC AP from a PR curve (eval_utils.py:43-74)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _aabb_iou(a: np.ndarray, b: np.ndarray) -> float:
    lo = np.maximum(a[0], b[0])
    hi = np.minimum(a[1], b[1])
    inter = np.prod(np.clip(hi - lo, 0, None))
    va = np.prod(a[1] - a[0])
    vb = np.prod(b[1] - b[0])
    return float(inter / (va + vb - inter))


def eval_det_cls(predictions: dict, gts: dict, iou_threshold: float = 0.25,
                 use_07_metric: bool = False) -> tuple[float, float, float]:
    """AP for one class (eval_utils.py:86-176).

    Args:
        predictions: {scene: [(aabb [2, 3], score)]}.
        gts: {scene: [aabb [2, 3]]}.

    Returns:
        (recall, precision, ap) at the final operating point + AP.
    """
    class_gts = {scene: np.zeros(len(boxes), bool) for scene, boxes in gts.items()}
    npos = sum(len(b) for b in gts.values())

    rows = []
    for scene, preds in predictions.items():
        for box, score in preds:
            rows.append((float(score), scene, np.asarray(box)))
    rows.sort(key=lambda r: -r[0])

    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for i, (_, scene, box) in enumerate(rows):
        best_iou, best_j = -np.inf, -1
        for j, gt_box in enumerate(gts.get(scene, [])):
            iou = _aabb_iou(box, np.asarray(gt_box))
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_iou > iou_threshold and not class_gts[scene][best_j]:
            tp[i] = 1.0
            class_gts[scene][best_j] = True
        else:
            fp[i] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / max(npos, 1)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(recall, precision, use_07_metric)
    final_r = float(recall[-1]) if len(recall) else 0.0
    final_p = float(precision[-1]) if len(precision) else 0.0
    return final_r, final_p, ap


def _eval_det_cls_task(task: tuple) -> tuple[int, tuple[float, float, float]]:
    """Picklable per-class worker for the multiprocessing path
    (the reference's eval_det_cls_wrapper, eval_utils.py:179-182)."""
    cls, preds, gts, iou_threshold = task
    return cls, eval_det_cls(preds, gts, iou_threshold)


def eval_det(all_predictions: dict, all_gts: dict, iou_threshold: float = 0.25,
             n_workers: int = 1) -> dict[int, dict]:
    """Multi-class detection evaluation (eval_utils.py:185-235).

    With ``n_workers > 1``, classes are scored by a ``multiprocessing`` pool
    of spawned processes, the reference's eval_det_multiprocessing variant
    (eval_utils.py:238-284).  Single-core hosts take the serial path (a
    pool on one core only adds start-up cost).

    Args:
        all_predictions: {scene: [(class, aabb, score)]}.
        all_gts: {scene: [(class, aabb)]}.
    """
    import os

    per_class_pred: dict[int, dict] = defaultdict(dict)
    per_class_gt: dict[int, dict] = defaultdict(dict)
    for scene, preds in all_predictions.items():
        for cls, box, score in preds:
            per_class_pred[cls].setdefault(scene, []).append((box, score))
    for scene, boxes in all_gts.items():
        for cls, box in boxes:
            per_class_gt[cls].setdefault(scene, []).append(box)

    tasks = []
    for cls in per_class_gt:
        preds = per_class_pred.get(cls, {})
        # scenes with GT but no predictions still count toward recall
        for scene in per_class_gt[cls]:
            preds.setdefault(scene, [])
        tasks.append((cls, preds, per_class_gt[cls], iou_threshold))

    n_workers = min(n_workers, os.cpu_count() or 1, max(len(tasks), 1))
    if n_workers > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
            results = pool.map(_eval_det_cls_task, tasks)
    else:
        results = [_eval_det_cls_task(t) for t in tasks]
    return {
        cls: {"recall": r, "precision": p, "ap": ap}
        for cls, (r, p, ap) in results
    }


def alignment_accuracy(pred_t: np.ndarray, pred_R: np.ndarray, pred_s: np.ndarray,
                       gt_t: np.ndarray, gt_R: np.ndarray, gt_s: np.ndarray,
                       iou: float | None = None,
                       t_threshold: float = 0.2, r_threshold_deg: float = 20.0,
                       s_threshold: float = 0.2,
                       n_rot_sym: int = 1) -> bool:
    """Scan2CAD alignment criterion (eval_utils.py:318-320, 362-384).

    A prediction is correct if translation/rotation/scale errors are all
    within thresholds (rotation tested over the object's rotational
    symmetries about +z), or if the oriented IoU exceeds 0.5.
    """
    if iou is not None and iou > 0.5:
        return True
    if np.linalg.norm(pred_t - gt_t) > t_threshold:
        return False
    s_err = np.abs(np.mean(pred_s / gt_s) - 1.0)
    if s_err > s_threshold:
        return False
    for k in range(max(n_rot_sym, 1)):
        ang = 2 * np.pi * k / max(n_rot_sym, 1)
        c, s = np.cos(ang), np.sin(ang)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        dR = pred_R @ Rz @ gt_R.T
        cos_theta = np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0)
        if np.degrees(np.arccos(cos_theta)) <= r_threshold_deg:
            return True
    return False
