"""Config-ablation matrix over the hard rehearsal split.

    python -m odam_torch.examples.cli_rehearsal.ablate [--data examples/cli_rehearsal/data_hard] \\
        [--out runs/cli_rehearsal/result_hard] [--detector_ckpt <weights>] \\
        [--associator_ckpt <weights>] [--full] [--device cpu]

Counterpart of ``examples/cli_rehearsal/ablate.py``: runs the CLI chain,
``python -m odam_torch.scripts.run_processor`` then ``python -m
odam_torch.scripts.eval_scan2cad``, with JAX's arguments for every
combination of the three accuracy-relevant config axes the pipeline
exposes — mapping solver (adam/lm), association decode (exact/greedy),
track re-projection (sampled/exact) — plus a deliberate fault injection
(``ODAM_FAULT_INJECT=stale_track_bbox``: skip the per-frame projected-bbox
refresh) that a discriminative benchmark must catch as an F1 drop.  The
pipeline runs on the card unless ``--device cpu`` (passed to
``run_processor``; JAX pins its children to the CPU instead).  The weights
default to the committed ``artifacts/torch/rehearsal_hard_{detr,assoc}.npz``.

Prints a table and writes ablation.json next to the results.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import time

from .common import ASSOC_WEIGHTS, DATA_HARD, DETR_WEIGHTS, REPO, RUNS


def _img_size(data):
    with open(os.path.join(data, "rehearsal.yaml")) as f:
        m = re.search(r"img_h:\s*(\d+)", f.read())
    return m.group(1)


def _eval_cmd(data, out_dir, min_views="10"):
    return [sys.executable, "-m", "odam_torch.scripts.eval_scan2cad",
            "--result_dir", out_dir,
            "--scan2cad", os.path.join(data, "full_annotations.json"),
            "--scans_root", os.path.join(data, "scans"),
            "--val_split", os.path.join(data, "val.txt"),
            "--min_views", min_views]


def _env(env_extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env.update(env_extra)
    return env


def run_config(data, out_root, name, extra_args, env_extra, ckpts, device="cuda"):
    """One cell: run_processor into ``out_root/name`` on ``device`` with
    ``env_extra`` in its environment, then eval_scan2cad."""
    out_dir = os.path.join(out_root, name)
    img = _img_size(data)
    env = _env(env_extra)
    t0 = time.time()
    _run_processor(data, out_dir, img, extra_args, ckpts, device, env, name)
    ev = subprocess.run(_eval_cmd(data, out_dir), cwd=REPO, env=env, capture_output=True,
                        text=True)
    if ev.returncode != 0:
        print(ev.stdout[-2000:], ev.stderr[-2000:])
        raise RuntimeError(f"eval failed for {name}")
    m = re.search(r"average: precision ([0-9.]+) recall ([0-9.]+) F1 ([0-9.]+)",
                  ev.stdout)
    prec, rec, f1 = (float(x) for x in m.groups())
    dt = time.time() - t0
    print(f"{name::>40}: F1 {f1:.3f} (P {prec:.3f} R {rec:.3f}) [{dt:.0f}s]", flush=True)
    return {"name": name, "precision": prec, "recall": rec, "f1": f1,
            "seconds": dt}


def _run_processor(data, out_dir, img, extra_args, ckpts, device, env, name):
    r = subprocess.run(
        [sys.executable, "-m", "odam_torch.scripts.run_processor",
         "--config_path", os.path.join(data, "rehearsal.yaml"),
         "--scans_root", os.path.join(data, "scans"),
         "--detector_ckpt", ckpts[0], "--associator_ckpt", ckpts[1],
         "--out_dir", out_dir, "--offline", "--use_prior",
         "--short_side", img, "--max_size", img, "--dtype", "float32",
         # static mapping shapes right-sized to the rehearsal scenes
         # (<=10 objects, 32 frames): identical results, ~16x less padded
         # mapping compute per cell
         "--max_objs", "24", "--max_views", "64",
         ] + extra_args + ["--device", device],
        cwd=REPO, env=env, capture_output=True, text=True,
    )
    if r.returncode != 0:
        print(r.stdout[-2000:], r.stderr[-2000:])
        raise RuntimeError(f"run_processor failed for {name}")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.cli_rehearsal.ablate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=DATA_HARD)
    ap.add_argument("--out", default=os.path.join(RUNS, "result_hard"))
    ap.add_argument("--detector_ckpt", default=DETR_WEIGHTS)
    ap.add_argument("--associator_ckpt", default=ASSOC_WEIGHTS)
    ap.add_argument("--full", action="store_true",
                    help="all 8 config cells (default: the 4 informative "
                         "ones: axes varied one at a time)")
    ap.add_argument("--device", default="cuda", help="run_processor's: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    data = os.path.abspath(args.data)
    ckpts = (os.path.abspath(args.detector_ckpt),
             os.path.abspath(args.associator_ckpt))

    results = []
    if args.full:
        combos = list(itertools.product(("adam", "lm"), ("exact", "greedy"),
                                        ("sampled", "exact")))
    else:
        combos = [("adam", "exact", "sampled"),   # reference semantics
                  ("lm", "exact", "sampled"),     # solver axis
                  ("adam", "greedy", "sampled"),  # decode axis
                  ("adam", "exact", "exact"),     # projection axis
                  ("lm", "greedy", "exact")]      # full fast profile

    def bank():
        # written after every cell: a killed matrix keeps its finished cells
        with open(os.path.join(args.out, "ablation.json"), "w") as f:
            json.dump(results, f, indent=1)

    for solver, decode, bbox in combos:
        name = f"{solver}_{decode}_{bbox}"
        results.append(run_config(
            data, args.out, name,
            ["--solver", solver, "--decode", decode, "--track_bbox", bbox],
            {}, ckpts, args.device,
        ))
        bank()

    # fault injection: a discriminative benchmark must catch this
    results.append(run_config(
        data, args.out, "FAULT_stale_track_bbox",
        ["--solver", "adam", "--decode", "exact", "--track_bbox", "sampled"],
        {"ODAM_FAULT_INJECT": "stale_track_bbox"}, ckpts, args.device,
    ))
    bank()
    base = results[0]["f1"]
    fault = results[-1]["f1"]
    print(f"\nbaseline F1 {base:.3f}; injected-bug F1 {fault:.3f} "
          f"(drop {base - fault:+.3f})")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
