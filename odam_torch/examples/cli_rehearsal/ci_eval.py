"""Scene-bootstrap scoring for the hard rehearsal.

    python -m odam_torch.examples.cli_rehearsal.ci_eval --result_dir <dir> \\
        [--data runs/cli_rehearsal/data_hard_big] [--min_views 10] [--boot 10000]

Counterpart of ``examples/cli_rehearsal/ci_eval.py``, the same host NumPy on
the port's ``eval.scan2cad``, ``utils.host_boxes`` and ``data.scannet``: on
the same result directory and seed it gives JAX's counts, per-object IoUs
and intervals exactly.  Three eval scenes (24 objects) make every headline
delta a 1-2-object flip, so this scorer gives every cell a confidence
interval and every pairwise decision a paired test:

- per-scene per-class counts (gts/preds/tps) under the exact reference
  protocol (greedy class-matched oriented-3D-IoU > threshold);
- a threshold-free sensitivity metric alongside F1: mean per-GT-object best
  same-class oriented IoU (0 if no prediction of the class) — degrading box
  quality always moves it, unlike thresholded F1, where a 0.26 -> 0.31 IoU
  change is invisible (this is what lets fault injection discriminate);
- nonparametric bootstrap over scenes (the protocol's independent unit) for
  95% CIs on avg P/R/F1/mIoU;
- paired bootstrap deltas between two cells over the same scenes for
  keep/cut decisions: resample scenes once, evaluate both cells on the same
  resample, CI on the difference.

Library use from ``ablate_big`` and ``window_experiment`` is the normal
path.  It runs no model.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ...data import scannet
from ...eval import scan2cad as s2c
from ...utils import host_boxes
from .common import RUNS

CLASSES = list(s2c.CARE_CLASSES)


def scene_table(result_dir: str, data_dir: str, min_views: int = 10,
                threshold: float = 0.25) -> dict:
    """Per-scene counts + per-GT-object best IoUs for one result dir.

    Returns {"scenes": [scene_id...], "counts": [n_scenes, n_cls, 3]
    (gts, preds, tps), "obj_ious": list per scene of [n_gt] best same-class
    pred IoU per GT object}.
    """
    with open(os.path.join(data_dir, "full_annotations.json")) as f:
        scan2cad = json.load(f)
    with open(os.path.join(data_dir, "val.txt")) as f:
        split = [l.strip() for l in f if l.strip()]

    predictions = s2c.load_predictions(result_dir, min_views)
    scenes, counts, obj_ious = [], [], []
    for scan in scan2cad:
        scene = scan["id_scan"]
        if scene not in split or scene not in predictions:
            continue
        meta = os.path.join(data_dir, "scans", scene, f"{scene}.txt")
        T_align = scannet.read_axis_align(meta)
        gts = s2c.parse_scan2cad_annotations(scan, T_align)
        preds = predictions[scene]

        cnt = np.zeros((len(CLASSES), 3), np.int64)
        for cat, _ in gts:
            cnt[CLASSES.index(cat), 0] += 1
        # exact reference matching order: iterate predictions, greedily take
        # the first unused same-class GT with IoU > threshold
        used = set()
        iou_cache = {}
        for p in preds:
            ci = CLASSES.index(p["class"])
            cnt[ci, 1] += 1
            for i, (cat, gt_box) in enumerate(gts):
                if cat != p["class"]:
                    continue
                iou, _ = host_boxes.box3d_iou(
                    np.asarray(gt_box, np.float64),
                    np.asarray(p["bbox"], np.float64))
                iou_cache[(id(p), i)] = iou
                if iou > threshold and i not in used:
                    used.add(i)
                    cnt[ci, 2] += 1
        # threshold-free: best same-class pred IoU per GT object
        best = np.zeros((len(gts),), np.float64)
        for i, (cat, gt_box) in enumerate(gts):
            for p in preds:
                if p["class"] != cat:
                    continue
                iou = iou_cache.get((id(p), i))
                if iou is None:
                    iou, _ = host_boxes.box3d_iou(
                        np.asarray(gt_box, np.float64),
                        np.asarray(p["bbox"], np.float64))
                best[i] = max(best[i], iou)
        scenes.append(scene)
        counts.append(cnt)
        obj_ious.append(best)
    return {"scenes": scenes, "counts": np.stack(counts), "obj_ious": obj_ious}


def _metrics(counts: np.ndarray, obj_ious: list) -> dict:
    """Aggregate protocol metrics from (a subset of) the scene table."""
    tot = counts.sum(0)  # [n_cls, 3]
    g, p, t = tot[:, 0].sum(), tot[:, 1].sum(), tot[:, 2].sum()
    prec = t / p if p else 0.0
    rec = t / g if g else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    all_ious = np.concatenate(obj_ious) if obj_ious else np.zeros((0,))
    miou = float(all_ious.mean()) if len(all_ious) else 0.0
    return {"precision": float(prec), "recall": float(rec), "f1": float(f1),
            "mean_obj_iou": miou, "n_gt": int(g), "n_pred": int(p),
            "n_tp": int(t)}


def bootstrap_ci(table: dict, n_boot: int = 10000, seed: int = 0,
                 alpha: float = 0.05) -> dict:
    """Point metrics + percentile-bootstrap CIs over scenes."""
    rng = np.random.default_rng(seed)
    S = len(table["scenes"])
    point = _metrics(table["counts"], table["obj_ious"])
    draws = {k: np.empty(n_boot) for k in ("precision", "recall", "f1",
                                           "mean_obj_iou")}
    for b in range(n_boot):
        idx = rng.integers(0, S, S)
        m = _metrics(table["counts"][idx], [table["obj_ious"][i] for i in idx])
        for k in draws:
            draws[k][b] = m[k]
    lo, hi = 100 * alpha / 2, 100 * (1 - alpha / 2)
    out = dict(point)
    out["n_scenes"] = S
    for k, d in draws.items():
        out[f"{k}_ci"] = [float(np.percentile(d, lo)),
                          float(np.percentile(d, hi))]
    return out


def paired_delta(table_a: dict, table_b: dict, n_boot: int = 10000,
                 seed: int = 0, alpha: float = 0.05) -> dict:
    """Paired bootstrap CI on (B - A) metric deltas over the same scenes."""
    assert table_a["scenes"] == table_b["scenes"], "cells must share the split"
    rng = np.random.default_rng(seed)
    S = len(table_a["scenes"])
    keys = ("precision", "recall", "f1", "mean_obj_iou")
    pa = _metrics(table_a["counts"], table_a["obj_ious"])
    pb = _metrics(table_b["counts"], table_b["obj_ious"])
    point = {k: pb[k] - pa[k] for k in keys}
    draws = {k: np.empty(n_boot) for k in keys}
    for b in range(n_boot):
        idx = rng.integers(0, S, S)
        ma = _metrics(table_a["counts"][idx],
                      [table_a["obj_ious"][i] for i in idx])
        mb = _metrics(table_b["counts"][idx],
                      [table_b["obj_ious"][i] for i in idx])
        for k in keys:
            draws[k][b] = mb[k] - ma[k]
    lo, hi = 100 * alpha / 2, 100 * (1 - alpha / 2)
    out = {}
    for k in keys:
        d = draws[k]
        out[k] = {"delta": float(point[k]),
                  "ci": [float(np.percentile(d, lo)),
                         float(np.percentile(d, hi))],
                  # fraction of resamples on the point-estimate's side of 0
                  "sign_consistency": float(np.mean(d * np.sign(point[k]) >= 0)
                                            if point[k] else 0.5)}
    return out


def fmt_cell(name: str, m: dict) -> str:
    return (f"{name:>34}: F1 {m['f1']:.3f} [{m['f1_ci'][0]:.3f},"
            f"{m['f1_ci'][1]:.3f}]  P {m['precision']:.3f}  "
            f"R {m['recall']:.3f} [{m['recall_ci'][0]:.3f},"
            f"{m['recall_ci'][1]:.3f}]  mIoU {m['mean_obj_iou']:.3f} "
            f"[{m['mean_obj_iou_ci'][0]:.3f},{m['mean_obj_iou_ci'][1]:.3f}]")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.cli_rehearsal.ci_eval",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--result_dir", required=True)
    ap.add_argument("--data", default=os.path.join(RUNS, "data_hard_big"))
    ap.add_argument("--min_views", type=int, default=10)
    ap.add_argument("--threshold", type=float, default=0.25)
    ap.add_argument("--boot", type=int, default=10000)
    args = ap.parse_args(argv)
    table = scene_table(args.result_dir, args.data, args.min_views,
                        args.threshold)
    m = bootstrap_ci(table, args.boot)
    print(fmt_cell(os.path.basename(args.result_dir.rstrip("/")), m))
    print(json.dumps(m, indent=1))
    return m


if __name__ == "__main__":
    main(sys.argv[1:])
