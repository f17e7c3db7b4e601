"""min_views operating-point sweep on the tuning split (eval-time only).

    python -m odam_torch.examples.cli_rehearsal.tune_min_views \\
        [--data runs/cli_rehearsal/data_hard_tune] [--results runs/cli_rehearsal/result_hard_tune]

Counterpart of ``examples/cli_rehearsal/tune_min_views.py`` through the
port's ``eval.scan2cad.evaluate``; it runs no model, so it pins no device.
The reference evaluates at ``--min_views 10`` (load_prediction_ours drops
tracks with fewer rows), and the miss audit classifies the dominant
remaining loss as ``short_track``: a well-placed track exists but
assembles < 10 rows under occlusion gaps.  min_views is purely an
eval-load filter, so existing result pickles can be re-scored without
re-running the pipeline: this sweeps min_views on the tune split over the
threshold sweep's result dirs (``tune_threshold``), prints the grid, and
the argmax is then reported once on the eval split.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ...eval import scan2cad as s2c
from .common import RUNS


def score(result_dir: str, data: str, min_views: int) -> dict:
    with open(os.path.join(data, "val.txt")) as f:
        sequences = f.read().splitlines()
    out = s2c.evaluate(
        result_dir,
        os.path.join(data, "full_annotations.json"),
        os.path.join(data, "scans"),
        sequences,
        min_views=min_views,
        verbose=False,
    )
    avg = out["average"]
    return {"min_views": min_views, "f1": round(avg["f1"], 4),
            "precision": round(avg["precision"], 4),
            "recall": round(avg["recall"], 4)}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.examples.cli_rehearsal.tune_min_views",
        description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=os.path.join(RUNS, "data_hard_tune"))
    ap.add_argument("--results", default=os.path.join(RUNS, "result_hard_tune"))
    ap.add_argument("--configs", default="thr0.6_att0.7,thr0.6_att0.8")
    ap.add_argument("--min_views", default="4,6,8,10")
    ap.add_argument("--out", default=None,
                    help="JSON output path (default <results>/min_views_sweep.json)")
    args = ap.parse_args(argv)

    rows = []
    for cfg in args.configs.split(","):
        rdir = os.path.join(args.results, cfg)
        if not os.path.isdir(rdir):
            print(f"skip {cfg}: no result dir {rdir}", file=sys.stderr)
            continue
        for mv in (int(v) for v in args.min_views.split(",")):
            r = {"config": cfg, **score(rdir, args.data, mv)}
            rows.append(r)
            print(f"{cfg} min_views={mv}: F1 {r['f1']:.3f} "
                  f"P {r['precision']:.3f} R {r['recall']:.3f}", flush=True)
    out = args.out or os.path.join(args.results, "min_views_sweep.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    best = max(rows, key=lambda r: r["f1"])
    print(f"\nbest on tuning split: {best['config']} min_views="
          f"{best['min_views']} (F1 {best['f1']:.3f}, "
          f"P {best['precision']:.3f}, R {best['recall']:.3f})")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
