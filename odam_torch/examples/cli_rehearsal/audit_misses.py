"""Per-object miss audit for a hard-rehearsal result directory.

    python -m odam_torch.examples.cli_rehearsal.audit_misses \\
        [--result_dir runs/cli_rehearsal/result_hard/adam_exact_sampled] [--json_out <file>]

Counterpart of ``examples/cli_rehearsal/audit_misses.py``: host NumPy on a
finished ``run_processor`` output, with the detector-implied per-row boxes
from the port's NumPy corners (``common.box_corners_np``, JAX's
``geometry.box3d_corners`` through ``jnp`` in JAX's), so it runs no model.
The ablation table and the recall decomposition say where the pipeline
loses F1 stage-wise; this tool says which eval objects are lost and why:

  matched        a prediction claimed it (TP)
  no_track       no final track's box overlaps it at any IoU > 0.05
  short_track    best-overlapping track exists but has < min_views rows
                 (detector misses / fragmentation starved it of views)
  bad_box        a >= min_views track overlaps (IoU > 0.05) but below the
                 0.25 protocol threshold (mapping/merge geometry error)
  wrong_class    a >= min_views track with IoU > 0.25 exists but its modal
                 class differs from GT (detector class confusion)
  stolen         an eligible prediction overlapped, but greedy matching
                 spent it on another GT first (duplicate merge failure)

It also prints, per GT object, detectable-frame counts
(``analyze_visibility``'s criterion) next to the views the winning track
actually assembled.  Every non-matched object with an overlapping track
carries a detector-vs-mapping decomposition from the result pickle alone:

  dl_iou         IoU of the same track's detector-average fallback box
                 (``bboxes_dl``) vs GT
  best_row_iou   best single-frame detector estimate: max IoU over the
                 per-row implied boxes (row cols 6:9 dims | 9:12 t_wo |
                 12 azi_wo, the track-row contract)
  frame_span     (first, last) frame id the track saw
  blame          bad_box attribution: "mapping" if the detector-average
                 box alone clears the 0.25 gate, "detector" if no single
                 frame's estimate clears it, else "aggregation" (good
                 frames exist but the fused state is bad)
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ...eval import scan2cad as s2c
from ...mapping.prior import CLASS_MAPPER
from ...utils import host_boxes
from . import hard
from .analyze_visibility import visible_flags
from .common import RUNS, box_corners_np


def _row_corners(rows: np.ndarray) -> np.ndarray:
    """Per-row detector-implied 3D boxes [n, 8, 3] (float32, as JAX's) from
    the track-row contract (6:9 dims | 9:12 t_wo | 12 azi_wo)."""
    return np.stack([box_corners_np(r[6:9], r[12], r[9:12]) for r in rows]
                    ).reshape(-1, 8, 3).astype(np.float32)


def audit_scene(seed: int, result_dir: str, min_views: int = 10,
                threshold: float = 0.25):
    scene = hard.hard_scene_id(seed)
    gts = s2c.parse_scan2cad_annotations(hard.hard_scene_annotation(seed))
    objects, flags, _, _ = visible_flags(seed)
    detectable = flags.sum(0)  # frames per instance

    path = os.path.join(result_dir, scene, scene)
    with open(path, "rb") as f:
        data = s2c._ResultUnpickler(f).load()   # either package's pickle
    tracks = [np.asarray(t, np.float64) for t in data["tracks"]]
    boxes = [np.asarray(b, np.float64) for b in data["bboxes_qc"]]
    # bboxes_dl (detector-average fallback boxes) feeds the
    # detector-vs-mapping blame decomposition; synthetic fixtures without
    # it still get mode classification, just no blame rows.
    boxes_dl = ([np.asarray(b, np.float64) for b in data["bboxes_dl"]]
                if "bboxes_dl" in data else None)
    classes = [CLASS_MAPPER.get(int(np.median(t[:, 1]))) for t in tracks]
    views = [len(t) for t in tracks]

    # replicate the evaluator's greedy matching to find which preds are spent
    eligible = [i for i in range(len(tracks))
                if views[i] >= min_views and classes[i] in s2c.CARE_CLASSES]
    used_gt: set[int] = set()
    claimed_by: dict[int, int] = {}
    for i in eligible:
        for g, (cat, gt_box) in enumerate(gts):
            if cat != classes[i] or g in used_gt:
                continue
            iou, _ = host_boxes.box3d_iou(np.asarray(gt_box), boxes[i])
            if iou > threshold:
                used_gt.add(g)
                claimed_by[g] = i
                break

    rows = []
    for g, (cat, gt_box) in enumerate(gts):
        ious = np.array([
            host_boxes.box3d_iou(np.asarray(gt_box), boxes[i])[0]
            for i in range(len(tracks))
        ]) if tracks else np.zeros(0)
        best = int(ious.argmax()) if len(ious) else -1
        best_iou = float(ious[best]) if best >= 0 else 0.0
        if g in claimed_by:
            mode = "matched"
            best = claimed_by[g]
            best_iou = float(host_boxes.box3d_iou(
                np.asarray(gt_box), boxes[best])[0])
        elif best_iou <= 0.05:
            mode = "no_track"
        elif views[best] < min_views:
            mode = "short_track"
        elif best_iou <= threshold:
            mode = "bad_box"
        elif classes[best] != cat:
            mode = "wrong_class"
        else:
            mode = "stolen"
        row = {
            "scene": scene, "gt": g, "class": cat,
            "detectable_frames": int(detectable[g]),
            "mode": mode, "best_iou": round(best_iou, 3),
            "track_views": int(views[best]) if best >= 0 else 0,
            "track_class": classes[best] if best >= 0 else None,
        }
        # detector-vs-mapping decomposition for every non-matched object
        # that has some overlapping track
        if mode not in ("matched", "no_track") and best >= 0 and \
                boxes_dl is not None:
            gt_c = np.asarray(gt_box)
            dl_iou = float(host_boxes.box3d_iou(gt_c, boxes_dl[best])[0])
            per_row = _row_corners(tracks[best])
            row_ious = [host_boxes.box3d_iou(gt_c, c)[0] for c in per_row]
            best_row_iou = float(max(row_ious)) if row_ious else 0.0
            fids = tracks[best][:, 0].astype(int)
            row["dl_iou"] = round(dl_iou, 3)
            row["best_row_iou"] = round(best_row_iou, 3)
            row["frame_span"] = [int(fids.min()), int(fids.max())]
            if mode == "bad_box":
                if dl_iou > threshold:
                    row["blame"] = "mapping"
                elif best_row_iou <= threshold:
                    row["blame"] = "detector"
                else:
                    row["blame"] = "aggregation"
        rows.append(row)
    # unclaimed >= min_views predictions are the precision hits
    fps = [i for i in eligible if i not in claimed_by.values()]
    return rows, [{"scene": scene, "track": i, "class": classes[i],
                   "views": views[i]} for i in fps]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.cli_rehearsal.audit_misses",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--result_dir",
                    default=os.path.join(RUNS, "result_hard", "adam_exact_sampled"))
    ap.add_argument("--min_views", type=int, default=10)
    ap.add_argument("--threshold", type=float, default=0.25)
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--seeds", default=None,
                    help="comma list of layout seeds (default hard.EVAL_SEEDS;"
                         " the big split is 0-17, ablate_big)")
    args = ap.parse_args(argv)

    seeds = (hard.EVAL_SEEDS if args.seeds is None
             else [int(s) for s in args.seeds.split(",")])
    all_rows, all_fps = [], []
    for seed in seeds:
        rows, fps = audit_scene(seed, args.result_dir, args.min_views,
                                args.threshold)
        all_rows += rows
        all_fps += fps

    hdr = f"{'scene':>14} {'gt':>3} {'class':>10} {'det.frames':>10} " \
          f"{'mode':>12} {'best_iou':>8} {'views':>5} {'trk class':>10}"
    print(hdr)
    print("-" * len(hdr))
    for r in all_rows:
        extra = ""
        if "dl_iou" in r:
            extra = (f"  dl {r['dl_iou']:.3f} bestrow {r['best_row_iou']:.3f}"
                     f" span {r['frame_span'][0]}-{r['frame_span'][1]}")
            if "blame" in r:
                extra += f" -> {r['blame']}"
        print(f"{r['scene']:>14} {r['gt']:>3} {r['class']:>10} "
              f"{r['detectable_frames']:>10} {r['mode']:>12} "
              f"{r['best_iou']:>8.3f} {r['track_views']:>5} "
              f"{str(r['track_class']):>10}{extra}")
    n = len(all_rows)
    matched = sum(r["mode"] == "matched" for r in all_rows)
    print(f"\nmatched {matched}/{n} (recall {matched / n:.3f})")
    by_mode: dict[str, int] = {}
    for r in all_rows:
        if r["mode"] != "matched":
            by_mode[r["mode"]] = by_mode.get(r["mode"], 0) + 1
    for m, c in sorted(by_mode.items(), key=lambda kv: -kv[1]):
        print(f"  {m}: {c}")
    blames = [r["blame"] for r in all_rows if "blame" in r]
    if blames:
        print("bad_box blame:", {b: blames.count(b) for b in set(blames)})
    if all_fps:
        print(f"unmatched predictions (precision hits): {len(all_fps)}")
        for p in all_fps:
            print(f"  {p['scene']} track {p['track']} class {p['class']} "
                  f"views {p['views']}")
    report = {"objects": all_rows, "false_positives": all_fps}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
