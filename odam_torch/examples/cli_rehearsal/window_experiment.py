"""Associator-window accuracy experiment: 100 (reference bound) vs 400.

    python -m odam_torch.examples.cli_rehearsal.window_experiment [--n_scenes 3] [--device cpu]

Counterpart of ``examples/cli_rehearsal/window_experiment.py``, on the card
unless ``--device cpu``.  The reference caps the association history at a
100-step window; the flash streaming-softmax kernel removes the memory
reason for that bound, and this experiment measures whether the capability
is worth anything: on streams long enough that 100 rows truncate history,
does window=400 change F1 / recall / fragmentation?

  1. data_hard_long: the hard eval layouts on one slow 480-frame orbit
     (``make_dataset --long``), written under ``runs/cli_rehearsal/``.
  2. Two associators fine-tuned from the committed w100 weights on
     long-stream (480-frame) training layouts, differing only in the
     training window (100 vs 400): ``python -m
     odam_torch.examples.cli_rehearsal.train associator 0 <steps> <ckpt>``
     with ``ODAM_WINDOW`` and ``ODAM_STREAM_FRAMES`` set.  The base is the
     committed ``.npz`` (JAX copies an orbax directory), written as a
     checkpoint directory without a ``global_step`` in its meta, which the
     trainer resumes from.  ``--ft_steps_w400`` gives the w400 arm its own
     (larger) budget, 4x by default; each arm reports a convergence check
     on its banked losses.
  3. run_processor --offline + eval_scan2cad per arm (the CLI chain), plus
     a fragmentation count (final tracks with >= min_views rows).

A quirk copied from JAX: the convergence check parses ``loss <x>`` from the
trainer's output, but the associator mode prints only ``nll <x>``, so the
banked-loss list is empty on both sides.

Writes <out>/window_experiment.json and prints the table.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

from .common import ASSOC_WEIGHTS, DETR_WEIGHTS, REPO, RUNS, load_params

FT_STEPS = 300
STREAM_FRAMES = 480


def sh(cmd, env_extra=None, timeout=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    t0 = time.time()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode != 0:
        print(r.stdout[-3000:], r.stderr[-3000:])
        raise RuntimeError(f"failed: {' '.join(cmd)}")
    return r.stdout, time.time() - t0


def ensure_data(data, n_scenes=3):
    val = os.path.join(data, "val.txt")
    if os.path.exists(val):
        with open(val) as f:
            if len([l for l in f if l.strip()]) >= n_scenes:
                return
    print(f"writing long-stream split ({n_scenes} scenes x "
          f"{STREAM_FRAMES} frames)...", flush=True)
    from . import make_dataset

    t0 = time.time()
    make_dataset.main_hard(data, seeds=tuple(range(n_scenes)),
                           n_frames=STREAM_FRAMES)
    print(f"[{time.time() - t0:.0f}s]", flush=True)


def base_checkpoint(base, out_ckpt) -> None:
    """``base`` (a ``.npz`` Flax tree or a checkpoint directory of the port's
    trainer) as the checkpoint directory ``out_ckpt`` with no meta, so that
    the fine-tune starts a fresh schedule from its weights."""
    from ...utils import checkpoint

    checkpoint.save(out_ckpt, load_params(base))


def finetune(window, base_ckpt, out_ckpt, steps=FT_STEPS, device="cuda"):
    """Fine-tune the committed associator on long streams at ``window``.

    Returns the banked-loss trajectory (for the convergence check); [] if
    the checkpoint already existed."""
    from ...utils import checkpoint

    if "global_step" in (checkpoint.load_meta(out_ckpt) or {}):
        print(f"{out_ckpt}: already trained", flush=True)
        return []
    if os.path.exists(out_ckpt):
        shutil.rmtree(out_ckpt)
    # restart the fine-tune schedule: the base carries no meta
    base_checkpoint(base_ckpt, out_ckpt)
    out, dt = sh(
        [sys.executable, "-m", "odam_torch.examples.cli_rehearsal.train",
         "associator", "0", str(steps), out_ckpt, "--device", device],
        env_extra={"ODAM_HARD": "1", "ODAM_WINDOW": str(window),
                   "ODAM_STREAM_FRAMES": str(STREAM_FRAMES)},
    )
    nll = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
    conv = ""
    if len(nll) >= 8:
        q = max(1, len(nll) // 4)
        last, prev = nll[-q:], nll[-2 * q:-q]
        conv = (f"  convergence: last-quarter mean {sum(last) / q:.3f} vs "
                f"prev {sum(prev) / q:.3f} "
                f"({(sum(last) - sum(prev)) / sum(prev) * 100:+.1f}%)")
    print(f"w{window} fine-tune ({steps} steps): final NLL "
          f"{nll[-1] if nll else '?'} [{dt:.0f}s]{conv}", flush=True)
    return nll


def run_arm(data, out_root, window, assoc_ckpt, detector_ckpt, min_views, device="cuda"):
    name = f"window{window}"
    out_dir = os.path.join(out_root, name)
    with open(os.path.join(data, "rehearsal.yaml")) as f:
        img = re.search(r"img_h:\s*(\d+)", f.read()).group(1)
    out, dt = sh(
        [sys.executable, "-m", "odam_torch.scripts.run_processor",
         "--config_path", os.path.join(data, "rehearsal.yaml"),
         "--scans_root", os.path.join(data, "scans"),
         "--detector_ckpt", detector_ckpt, "--associator_ckpt", assoc_ckpt,
         "--out_dir", out_dir, "--offline", "--use_prior",
         "--short_side", img, "--max_size", img, "--dtype", "float32",
         "--max_objs", "24", "--max_views", "128",
         "--window", str(window), "--device", device],
    )
    ev, _ = sh(
        [sys.executable, "-m", "odam_torch.scripts.eval_scan2cad",
         "--result_dir", out_dir,
         "--scan2cad", os.path.join(data, "full_annotations.json"),
         "--scans_root", os.path.join(data, "scans"),
         "--val_split", os.path.join(data, "val.txt"),
         "--min_views", str(min_views)],
    )
    m = re.search(r"average: precision ([0-9.]+) recall ([0-9.]+) F1 ([0-9.]+)", ev)
    prec, rec, f1 = (float(x) for x in m.groups())

    # fragmentation: final tracks per scene (eligible >= min_views), vs GT
    import pickle

    import numpy as np
    n_tracks = n_eligible = 0
    for scene in open(os.path.join(data, "val.txt")).read().split():
        with open(os.path.join(out_dir, scene, scene), "rb") as f:
            d = pickle.load(f)
        n_tracks += len(d["tracks"])
        n_eligible += sum(len(np.asarray(t)) >= min_views for t in d["tracks"])
    print(f"{name}: F1 {f1:.3f} (P {prec:.3f} R {rec:.3f}) "
          f"tracks {n_tracks} (eligible {n_eligible}) [{dt:.0f}s]", flush=True)
    return {"window": window, "f1": f1, "precision": prec, "recall": rec,
            "tracks": n_tracks, "eligible_tracks": n_eligible,
            "pipeline_seconds": dt}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.examples.cli_rehearsal.window_experiment",
        description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=os.path.join(RUNS, "data_hard_long"))
    ap.add_argument("--out", default=os.path.join(RUNS, "result_window"))
    ap.add_argument("--detector_ckpt", default=DETR_WEIGHTS)
    ap.add_argument("--base_assoc", default=ASSOC_WEIGHTS)
    ap.add_argument("--min_views", type=int, default=10)
    ap.add_argument("--ft_steps", type=int, default=FT_STEPS)
    ap.add_argument("--ft_steps_w400", type=int, default=None,
                    help="w400 arm's own update budget (default 4x --ft_steps)")
    ap.add_argument("--n_scenes", type=int, default=3,
                    help="long-split size (seeds 0..n-1); >3 enables the "
                         "scene-bootstrap CI on the decision delta")
    ap.add_argument("--json_name", default="window_experiment.json")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ensure_data(args.data, args.n_scenes)
    os.makedirs(args.out, exist_ok=True)
    w400_steps = args.ft_steps_w400 or 4 * args.ft_steps
    results, losses = [], {}
    for window, steps in ((100, args.ft_steps), (400, w400_steps)):
        ck = os.path.join(args.out, f"assoc_w{window}_long_ckpt")
        losses[window] = finetune(window, args.base_assoc, ck, steps=steps,
                                  device=args.device)
        r = run_arm(args.data, args.out, window, ck,
                    args.detector_ckpt, args.min_views, args.device)
        r["ft_steps"] = steps
        r["banked_losses"] = losses[window]
        results.append(r)
        with open(os.path.join(args.out, args.json_name), "w") as f:
            json.dump(results, f, indent=1)
    if len(results) == 2:
        d = results[1]["f1"] - results[0]["f1"]
        print(f"window 400 vs 100: dF1 {d:+.3f}, "
              f"dR {results[1]['recall'] - results[0]['recall']:+.3f}, "
              f"tracks {results[0]['tracks']} -> {results[1]['tracks']}")
        # scene-bootstrap paired delta (decision-grade when n_scenes > 3)
        from . import ci_eval

        tables = {w: ci_eval.scene_table(
            os.path.join(args.out, f"window{w}"), args.data,
            min_views=args.min_views) for w in (100, 400)}
        delta = ci_eval.paired_delta(tables[100], tables[400], 10000)
        for w in (100, 400):
            m = ci_eval.bootstrap_ci(tables[w], 10000)
            print(ci_eval.fmt_cell(f"window{w}", m), flush=True)
        f1d, md = delta["f1"], delta["mean_obj_iou"]
        print(f"DELTA w400 - w100: dF1 {f1d['delta']:+.3f} CI "
              f"[{f1d['ci'][0]:+.3f},{f1d['ci'][1]:+.3f}]  dmIoU "
              f"{md['delta']:+.3f} CI [{md['ci'][0]:+.3f},{md['ci'][1]:+.3f}]")
        results.append({"paired_delta_w400_minus_w100": delta})
        with open(os.path.join(args.out, args.json_name), "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
