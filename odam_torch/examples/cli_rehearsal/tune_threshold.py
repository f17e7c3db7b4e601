"""Detection-threshold operating-point sweep on the tuning split.

    python -m odam_torch.examples.cli_rehearsal.make_dataset runs/cli_rehearsal/data_hard_tune --tune
    python -m odam_torch.examples.cli_rehearsal.tune_threshold [--device cpu]

Counterpart of ``examples/cli_rehearsal/tune_threshold.py`` on the port's
``ablate.run_config`` (the pipeline on the card unless ``--device cpu``).
The pipeline's detect_threshold (default 0.6, the reference's operating
point) trades precision for recall; the hard rehearsal measured precision
headroom (P 0.923 at R 0.500), so a lower threshold may net F1.  Selecting
it on the eval scenes would overfit the benchmark: this sweep runs the
full run_processor -> eval_scan2cad chain on ``hard.TUNE_SEEDS`` layouts
(never trained on, never evaluated), picks the F1-argmax, and the chosen
value is then reported once on the eval split as a separate ablation row.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .ablate import run_config
from .common import ASSOC_WEIGHTS, DETR_WEIGHTS, RUNS


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.examples.cli_rehearsal.tune_threshold",
        description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=os.path.join(RUNS, "data_hard_tune"))
    ap.add_argument("--out", default=os.path.join(RUNS, "result_hard_tune"))
    ap.add_argument("--detector_ckpt", default=DETR_WEIGHTS)
    ap.add_argument("--associator_ckpt", default=ASSOC_WEIGHTS)
    ap.add_argument("--thresholds", default="0.4,0.5,0.6,0.7",
                    help="detect_threshold values")
    ap.add_argument("--attach", default="0.8",
                    help="attach_threshold values (grid with --thresholds)")
    ap.add_argument("--device", default="cuda", help="run_processor's: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    data = os.path.abspath(args.data)
    ckpts = (os.path.abspath(args.detector_ckpt),
             os.path.abspath(args.associator_ckpt))

    results = []
    for thr in (float(t) for t in args.thresholds.split(",")):
        for att in (float(a) for a in args.attach.split(",")):
            results.append(run_config(
                data, args.out, f"thr{thr:g}_att{att:g}",
                ["--solver", "adam", "--decode", "exact",
                 "--track_bbox", "sampled",
                 "--detect_threshold", str(thr),
                 "--attach_threshold", str(att)],
                {}, ckpts, args.device,
            ))
            with open(os.path.join(args.out, "threshold_sweep.json"), "w") as f:
                json.dump(results, f, indent=1)
    best = max(results, key=lambda r: r["f1"])
    print(f"\nbest on tuning split: {best['name']} "
          f"(F1 {best['f1']:.3f}, P {best['precision']:.3f}, "
          f"R {best['recall']:.3f})")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
