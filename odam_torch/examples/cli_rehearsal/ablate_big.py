"""Enlarged-split ablation matrix with bootstrap CIs.

    python -m odam_torch.examples.cli_rehearsal.ablate_big [--cells baseline,lm,...] \\
        [--skip_tune] [--score_only] [--device cpu]

Counterpart of ``examples/cli_rehearsal/ablate_big.py`` on the port's
``ablate.run_config`` and ``ci_eval`` (the pipeline on the card unless
``--device cpu``).  Three eval scenes (24 objects) make every delta a 1-2-
object flip, so this script:

- generates a 6x larger eval split (18 scenes, hard seeds 0-17 — all
  outside the tuning seeds 50+ and the training draw [100, 100000)) and a
  matching 18-scene tune split (seeds 50-67) with the port's
  ``make_dataset.main_hard``, under ``runs/cli_rehearsal/`` by default
  (the port never writes into ``examples/``);
- runs each config cell once through ``run_processor`` -> result pickles
  (the expensive part; cells are resumable — a finished out_dir is
  skipped, a killed pass keeps its finished scenes);
- scores every cell with scene-bootstrap CIs and the threshold-free
  mean-object-IoU sensitivity metric (``ci_eval``), and computes paired
  bootstrap deltas for each keep/cut decision (:func:`score`).

Cells: the 5-cell informative matrix + fault injection (``ablate``'s
lineage), the tuned attach-0.7 operating points, and the two alternative
representations (quadric / cube) the reference CLI exposes.  The weights
default to the committed ``artifacts/torch/rehearsal_hard_{detr,assoc}.npz``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import ci_eval
from .ablate import run_config
from .common import ASSOC_WEIGHTS, DETR_WEIGHTS, RUNS

BIG_EVAL_SEEDS = tuple(range(0, 18))    # includes the original 0-2
BIG_TUNE_SEEDS = tuple(range(50, 68))   # includes the original 50-52

# cell name -> (run_processor extra args, env extras)
EVAL_CELLS = {
    "adam_exact_sampled": (["--solver", "adam", "--decode", "exact",
                            "--track_bbox", "sampled"], {}),
    "lm_exact_sampled": (["--solver", "lm", "--decode", "exact",
                          "--track_bbox", "sampled"], {}),
    "adam_greedy_sampled": (["--solver", "adam", "--decode", "greedy",
                             "--track_bbox", "sampled"], {}),
    "adam_exact_exact": (["--solver", "adam", "--decode", "exact",
                          "--track_bbox", "exact"], {}),
    "lm_greedy_exact": (["--solver", "lm", "--decode", "greedy",
                         "--track_bbox", "exact"], {}),
    "FAULT_stale_track_bbox": (["--solver", "adam", "--decode", "exact",
                                "--track_bbox", "sampled"],
                               {"ODAM_FAULT_INJECT": "stale_track_bbox"}),
    "FAULT_no_border_filter": (["--solver", "adam", "--decode", "exact",
                                "--track_bbox", "sampled"],
                               {"ODAM_FAULT_INJECT": "no_border_filter"}),
    "FAULT_off_by_one_pose": (["--solver", "adam", "--decode", "exact",
                               "--track_bbox", "sampled"],
                              {"ODAM_FAULT_INJECT": "off_by_one_pose"}),
    "adam_exact_sampled_att0.7": (["--solver", "adam", "--decode", "exact",
                                   "--track_bbox", "sampled",
                                   "--attach_threshold", "0.7"], {}),
    "lm_exact_sampled_att0.7": (["--solver", "lm", "--decode", "exact",
                                 "--track_bbox", "sampled",
                                 "--attach_threshold", "0.7"], {}),
    "rep_quadric": (["--solver", "adam", "--decode", "exact",
                     "--track_bbox", "sampled",
                     "--representation", "quadric"], {}),
    "rep_cube": (["--solver", "adam", "--decode", "exact",
                  "--track_bbox", "sampled",
                  "--representation", "cube"], {}),
    # reported on eval only because the tune split selected it (median
    # track aggregation)
    "adam_exact_sampled_att0.7_robust": (
        ["--solver", "adam", "--decode", "exact", "--track_bbox", "sampled",
         "--attach_threshold", "0.7", "--robust_init"], {}),
}

TUNE_CELLS = {
    "tune_att0.8": (["--solver", "adam", "--decode", "exact",
                     "--track_bbox", "sampled"], {}),
    "tune_att0.7": (["--solver", "adam", "--decode", "exact",
                     "--track_bbox", "sampled",
                     "--attach_threshold", "0.7"], {}),
    "tune_att0.7_robust": (["--solver", "adam", "--decode", "exact",
                            "--track_bbox", "sampled",
                            "--attach_threshold", "0.7", "--robust_init"], {}),
}

# keep/cut decisions -> (cell A, cell B, the claim being re-tested)
DECISIONS = [
    ("adam_exact_sampled", "lm_exact_sampled",
     "solver axis: LM vs Adam at reference thresholds"),
    ("adam_exact_sampled", "adam_greedy_sampled",
     "decode axis: greedy vs exact (claimed neutral)"),
    ("adam_exact_sampled", "adam_exact_exact",
     "projection axis: closed-form vs sampled (claimed neutral)"),
    ("adam_exact_sampled", "lm_greedy_exact",
     "full fast profile vs reference semantics"),
    # decode+projection tested jointly at the LM point: with the solver
    # axis held fixed this isolates exactly the two "claimed neutral"
    # substitutions
    ("lm_exact_sampled", "lm_greedy_exact",
     "decode+projection axes jointly at LM (claimed neutral)"),
    ("adam_exact_sampled", "FAULT_stale_track_bbox",
     "fault injection: stale track bbox MUST be worse"),
    ("adam_exact_sampled", "FAULT_no_border_filter",
     "fault injection: unfiltered truncated edges MUST be worse"),
    ("adam_exact_sampled", "FAULT_off_by_one_pose",
     "fault injection: off-by-one pose indexing MUST be worse"),
    ("adam_exact_sampled", "adam_exact_sampled_att0.7",
     "attach 0.7 operating point (tuned on tune split)"),
    ("adam_exact_sampled_att0.7", "lm_exact_sampled_att0.7",
     "solver axis at the tuned operating point"),
    ("adam_exact_sampled", "rep_quadric",
     "representation=quadric vs super_quadric"),
    ("adam_exact_sampled", "rep_cube",
     "representation=cube vs super_quadric"),
    ("adam_exact_sampled_att0.7", "adam_exact_sampled_att0.7_robust",
     "robust (median) track aggregation vs reference mean (miss-"
     "decomposition fix; selected on the tune split)"),
]


def cell_done(out_dir: str, n_scenes: int) -> bool:
    if not os.path.isdir(out_dir):
        return False
    done = [s for s in os.listdir(out_dir)
            if os.path.exists(os.path.join(out_dir, s, s))]
    return len(done) >= n_scenes


def ensure_split(root: str, seeds) -> None:
    val = os.path.join(root, "val.txt")
    if os.path.exists(val):
        with open(val) as f:
            if len([l for l in f if l.strip()]) == len(seeds):
                return
    from . import make_dataset

    print(f"generating split {root} ({len(seeds)} scenes)...", flush=True)
    make_dataset.main_hard(root, seeds=seeds)


def score(data, out, wanted, tune_data=None, tune_out=None, boot=10000) -> dict:
    """The scoring pass: every cell of ``wanted`` under ``out`` at min_views
    10 and 6 (and the tune cells under ``tune_out`` at 4-10), with
    scene-bootstrap CIs, and the paired deltas of every decision whose two
    cells were scored; writes ``out/big_matrix.json``."""
    report = {"eval": {}, "tune": {}, "decisions": [],
              "protocol": {"boot": boot, "threshold": 0.25,
                           "eval_scenes": len(BIG_EVAL_SEEDS),
                           "tune_scenes": len(BIG_TUNE_SEEDS)}}
    tables = {}
    for name in wanted:
        out_dir = os.path.join(out, name)
        if not os.path.isdir(out_dir):
            continue
        for mv in (10, 6):
            t = ci_eval.scene_table(out_dir, data, min_views=mv)
            tables[(name, mv)] = t
            m = ci_eval.bootstrap_ci(t, boot)
            report["eval"][f"{name}_mv{mv}"] = m
            print(ci_eval.fmt_cell(f"{name} mv{mv}", m), flush=True)
    if tune_out is not None:
        for name in TUNE_CELLS:
            out_dir = os.path.join(tune_out, name)
            if not os.path.isdir(out_dir):
                continue
            for mv in (4, 6, 8, 10):
                t = ci_eval.scene_table(out_dir, tune_data, min_views=mv)
                m = ci_eval.bootstrap_ci(t, boot)
                report["tune"][f"{name}_mv{mv}"] = m
                print(ci_eval.fmt_cell(f"[tune] {name} mv{mv}", m), flush=True)

    for a, b, claim in DECISIONS:
        if (a, 10) not in tables or (b, 10) not in tables:
            continue
        d = ci_eval.paired_delta(tables[(a, 10)], tables[(b, 10)], boot)
        report["decisions"].append({"a": a, "b": b, "claim": claim,
                                    "delta_b_minus_a": d})
        f1d, md = d["f1"], d["mean_obj_iou"]
        print(f"DELTA {b} - {a} ({claim}):\n"
              f"    dF1 {f1d['delta']:+.3f} CI [{f1d['ci'][0]:+.3f},"
              f"{f1d['ci'][1]:+.3f}]  dmIoU {md['delta']:+.3f} "
              f"CI [{md['ci'][0]:+.3f},{md['ci'][1]:+.3f}]", flush=True)

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "big_matrix.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {os.path.join(out, 'big_matrix.json')}")
    return report


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.cli_rehearsal.ablate_big",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=os.path.join(RUNS, "data_hard_big"))
    ap.add_argument("--tune_data", default=os.path.join(RUNS, "data_hard_tune_big"))
    ap.add_argument("--out", default=os.path.join(RUNS, "result_hard_big"))
    ap.add_argument("--tune_out", default=os.path.join(RUNS, "result_hard_tune_big"))
    ap.add_argument("--detector_ckpt", default=DETR_WEIGHTS)
    ap.add_argument("--associator_ckpt", default=ASSOC_WEIGHTS)
    ap.add_argument("--cells", default=None,
                    help="comma list; default = all eval cells")
    ap.add_argument("--skip_tune", action="store_true")
    ap.add_argument("--boot", type=int, default=10000)
    ap.add_argument("--score_only", action="store_true",
                    help="skip pipeline runs; score existing result dirs")
    ap.add_argument("--device", default="cuda", help="run_processor's: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ensure_split(args.data, BIG_EVAL_SEEDS)
    if not args.skip_tune:
        ensure_split(args.tune_data, BIG_TUNE_SEEDS)

    ckpts = (os.path.abspath(args.detector_ckpt),
             os.path.abspath(args.associator_ckpt))
    wanted = (args.cells.split(",") if args.cells else list(EVAL_CELLS))

    # ---- pipeline passes (resumable) ----
    runs = [(args.data, args.out, n, *EVAL_CELLS[n]) for n in wanted]
    if not args.skip_tune:
        runs += [(args.tune_data, args.tune_out, n, *TUNE_CELLS[n])
                 for n in TUNE_CELLS]
    for data, out_root, name, extra, env in runs:
        out_dir = os.path.join(out_root, name)
        with open(os.path.join(data, "val.txt")) as f:
            n_scenes = len([l for l in f if l.strip()])
        if args.score_only or cell_done(out_dir, n_scenes):
            print(f"cell {name}: already complete ({out_dir})", flush=True)
            continue
        t0 = time.time()
        # --resume: a killed pass keeps its finished scenes
        run_config(data, out_root, name, extra + ["--resume"], env, ckpts, args.device)
        print(f"cell {name}: pipeline pass {time.time() - t0:.0f}s",
              flush=True)

    # ---- scoring with CIs ----
    return score(args.data, args.out, wanted,
                 None if args.skip_tune else args.tune_data,
                 None if args.skip_tune else args.tune_out, args.boot)


if __name__ == "__main__":
    main(sys.argv[1:])
