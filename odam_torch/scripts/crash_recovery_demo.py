"""Crash-recovery demonstration: training survives a kill in the middle of a save.

    python -m odam_torch.scripts.crash_recovery_demo --mode detector_frozen \\
        --steps 2000 --bank 400 [--kill mid_save|none]

Counterpart of ``scripts/crash_recovery_demo.py``, with its protocol, flags
and JSON keys.  Each segment is a process of the rehearsal trainer,
``python -m odam_torch.examples.cli_rehearsal.train <mode> <seg> <steps>
<ckpt>`` (``ODAM_BANK`` = ``--bank``, ``ODAM_DECAY_STEPS`` = ``--steps``):

1. an uninterrupted baseline of ``--steps`` steps (segment 0);
2. the same run into another checkpoint, SIGKILLed the moment its second
   bank's ``<ckpt>.tmp`` directory is on disk, i.e. in the middle of the
   write (:func:`odam_torch.utils.checkpoint.save` writes ``.tmp`` and swaps
   it in by renames);
3. a fresh process that resumes from the newest complete checkpoint
   (:func:`odam_torch.utils.checkpoint.latest_path`) and trains the rest:
   in ``detector_frozen`` mode, as JAX's demo, segment 1 of the remaining
   steps; in ``detector`` mode segment 0 again, which the trainer resumes at
   its banked step (JAX's demo runs segment 1 there too, which its trainer's
   provenance check refuses).

A segment restart builds a fresh optimizer, in both packages, so the final
losses of 1 and 3 agree only within ``--tol`` (relative, JAX's 0.15).  One
JSON line reports the outcome; the tool raises if the losses disagree.  The
trainer runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAINER = "odam_torch.examples.cli_rehearsal.train"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.crash_recovery_demo",
                                 description="Kill a training run mid-save, resume it, and "
                                             "compare with an uninterrupted run (PyTorch port).")
    ap.add_argument("--mode", default="detector_frozen", choices=["detector", "detector_frozen"],
                    help="detector: the whole DETR's fwd+bwd; detector_frozen: the head on "
                         "cached backbone features")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--bank", type=int, default=400, help="save every this many steps")
    ap.add_argument("--kill", default="mid_save", choices=["mid_save", "none"],
                    help="mid_save: SIGKILL when the second bank's .tmp directory appears; "
                         "none: let the run end by itself")
    ap.add_argument("--tol", type=float, default=0.15,
                    help="relative tolerance on the final loss against the uninterrupted run")
    ap.add_argument("--workdir", default=os.path.join("runs", "crash_recovery_demo"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def run_segment(args, seg: int, steps: int, ckpt: str, log) -> subprocess.Popen:
    """One trainer process, its stdout and stderr into ``log``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["ODAM_BANK"] = str(args.bank)
    env["ODAM_DECAY_STEPS"] = str(args.steps)
    cmd = [sys.executable, "-m", TRAINER, args.mode, str(seg), str(steps), ckpt,
           "--device", args.device]
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)


def final_loss(log_path: str) -> float | None:
    """The last loss the trainer printed (a bank's or the segment's)."""
    with open(log_path) as f:
        losses = re.findall(r"loss ([0-9.]+)", f.read())
    return float(losses[-1]) if losses else None


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    from .. import resolve_device
    from ..utils import checkpoint

    resolve_device(args.device)     # no card and no --device cpu: raise before any run
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    workdir = os.path.abspath(args.workdir)

    # ---- baseline: uninterrupted run
    base_log = os.path.join(workdir, "baseline.log")
    t0 = time.time()
    with open(base_log, "w") as f:
        p = run_segment(args, 0, args.steps, os.path.join(workdir, "baseline_ckpt"), f)
        p.wait()
    if p.returncode != 0:
        raise RuntimeError(f"baseline failed ({p.returncode}); see {base_log}")
    base_final = final_loss(base_log)
    print(f"baseline: {args.steps} steps in {time.time() - t0:.1f}s, final loss {base_final}",
          flush=True)

    # ---- interrupted run
    ckpt = os.path.join(workdir, "crash_ckpt")
    tmp = ckpt + ".tmp"
    log1 = os.path.join(workdir, "crash_seg0.log")
    killed, saves_seen = None, 0
    with open(log1, "w") as f:
        p = run_segment(args, 0, args.steps, ckpt, f)
        while p.poll() is None:
            if args.kill == "mid_save" and os.path.isdir(tmp):
                saves_seen += 1
                if saves_seen >= 2:      # let the first bank commit, kill the second
                    os.kill(p.pid, signal.SIGKILL)
                    killed = "SIGKILL"
                    break
                while os.path.isdir(tmp) and p.poll() is None:
                    time.sleep(0.002)    # wait out the first save
            time.sleep(0.002)
        p.wait()
    # the .tmp outlives the kill without its meta only if the save was cut
    mid_save = killed is not None and os.path.isdir(tmp) and checkpoint.latest_path(ckpt) != tmp
    if killed is not None:
        killed = f"SIGKILL {'mid-save' if mid_save else 'after the save'} (crash_ckpt.tmp present)"
    else:
        killed = (f"natural exit rc={p.returncode}" if p.returncode
                  else "completed uninterrupted")
    print(f"interruption: {killed}", flush=True)

    # ---- recovery: a fresh process restores the banked state and continues
    t0 = time.time()
    latest = checkpoint.latest_path(ckpt)
    if latest is None:
        raise RuntimeError("no intact checkpoint survived the kill")
    done = int(checkpoint.load_meta(ckpt)["global_step"])
    print(f"intact checkpoint after kill: {latest} (global step {done})", flush=True)
    remaining = max(args.steps - done, 1)
    seg, seg_steps = (0, args.steps) if args.mode == "detector" else (1, remaining)
    log2 = os.path.join(workdir, "crash_seg1.log")
    with open(log2, "w") as f:
        p = run_segment(args, seg, seg_steps, ckpt, f)
        p.wait()
    if p.returncode != 0:
        raise RuntimeError(f"recovery segment failed ({p.returncode}); see {log2}")
    with open(log2) as f:
        if "resumed from" not in f.read():
            raise RuntimeError("the recovery segment did not restore a checkpoint")
    rec_final = final_loss(log2)
    print(f"recovery: restored + {remaining} steps in {time.time() - t0:.1f}s, "
          f"final loss {rec_final}", flush=True)

    rel = abs(rec_final - base_final) / max(abs(base_final), 1e-6)
    result = {
        "mode": args.mode,
        "steps": args.steps,
        "interruption": killed,
        "killed_mid_save": mid_save,
        "banked_steps_at_kill": done,
        "recovery_segment": [seg, seg_steps],
        "baseline_final_loss": base_final,
        "recovered_final_loss": rec_final,
        "relative_diff": rel,
        "within_tolerance": rel <= args.tol,
        "device": args.device,
    }
    print(json.dumps(result), flush=True)
    if not rel <= args.tol:
        raise RuntimeError(f"resume-after-fault diverged from uninterrupted training: {result}")
    return result


if __name__ == "__main__":
    main()
