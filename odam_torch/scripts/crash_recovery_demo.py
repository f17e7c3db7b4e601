"""Crash-recovery demonstration: training survives a kill in the middle of a save.

    python -m odam_torch.scripts.crash_recovery_demo --steps 40 --bank 10 [--kill mid_save|none]

Counterpart of ``scripts/crash_recovery_demo.py``, with the same protocol
and JSON keys; the trainer is the port's own, ``python -m
odam_torch.scripts.train_detector --synthetic`` (JAX's demo drives the
rehearsal trainer of ``examples/cli_rehearsal``), on the DETR of
``--config_path``:

1. an uninterrupted baseline of ``--steps`` steps, saving every ``--bank``
   steps (``--save_every``);
2. the same run in a new directory, SIGKILLed the moment a save at step
   2 x bank or later has its ``ckpt_<step>.tmp`` directory on disk, i.e. in
   the middle of the write (:func:`odam_torch.utils.checkpoint.save` writes
   ``.tmp`` and swaps it in by renames);
3. a fresh process that resumes (``--resume_ckpt``) from the newest complete
   checkpoint (:func:`odam_torch.utils.checkpoint.latest_path` of each
   ``ckpt_<step>``) and runs to ``--steps``.

The final losses of 1 and 3 must agree within ``--tol`` (relative).  The
port's ``--resume_ckpt`` restores the optimizer state and continues the
seeded batch stream and dropout at its step, so on one device they agree
to rounding.  One JSON line reports the outcome; the tool raises if the
losses disagree.  The trainer runs on the card unless ``--device cpu``.
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
REHEARSAL = os.path.join("examples", "cli_rehearsal", "data_hard", "rehearsal.yaml")
CKPT = re.compile(r"^ckpt_(\d+)(\.tmp|\.bak)?$")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.crash_recovery_demo",
                                 description="Kill a training run mid-save, resume it, and "
                                             "compare with an uninterrupted run (PyTorch port).")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--bank", type=int, default=400, help="save every this many steps")
    ap.add_argument("--kill", default="mid_save", choices=["mid_save", "none"],
                    help="mid_save: SIGKILL when a checkpoint's .tmp directory appears; "
                         "none: let the run end by itself")
    ap.add_argument("--tol", type=float, default=0.15,
                    help="relative tolerance on the final loss against the uninterrupted run")
    ap.add_argument("--workdir", default=os.path.join("runs", "crash_recovery_demo"))
    ap.add_argument("--config_path", default=REHEARSAL)
    ap.add_argument("--img_h", type=int, default=192)
    ap.add_argument("--img_w", type=int, default=192)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--dtype", default="float32", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def run_segment(args, out_dir: str, log, resume: str | None = None) -> subprocess.Popen:
    """One trainer process, its stdout and stderr into ``log``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "odam_torch.scripts.train_detector", "--synthetic",
           "--config_path", args.config_path, "--steps", str(args.steps),
           "--save_every", str(args.bank), "--log_every", "1", "--out_dir", out_dir,
           "--img_h", str(args.img_h), "--img_w", str(args.img_w),
           "--batch_size", str(args.batch_size), "--dtype", args.dtype,
           "--device", args.device]
    if resume is not None:
        cmd += ["--resume_ckpt", resume]
    return subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)


def final_loss(log_path: str) -> float | None:
    """The last weighted total loss the trainer logged (its ``total`` metric)."""
    with open(log_path) as f:
        losses = re.findall(r"(?:^|\s)total: (\S+)", f.read())
    return float(losses[-1]) if losses else None


def saves_in_flight(out_dir: str, min_step: int) -> list[str]:
    """The ``ckpt_<step>.tmp`` directories of saves at ``min_step`` or later."""
    if not os.path.isdir(out_dir):
        return []
    return [os.path.join(out_dir, n) for n in os.listdir(out_dir)
            if (m := CKPT.match(n)) and m.group(2) == ".tmp" and int(m.group(1)) >= min_step]


def newest_checkpoint(out_dir: str) -> tuple[str, int] | None:
    """(``ckpt_<step>`` path, step) of the newest complete checkpoint: of each
    step's ``ckpt_<step>``, ``.tmp`` and ``.bak``, the one
    ``checkpoint.latest_path`` finds."""
    from ..utils import checkpoint

    steps = sorted({int(m.group(1)) for n in os.listdir(out_dir) if (m := CKPT.match(n))},
                   reverse=True)
    for step in steps:
        base = os.path.join(out_dir, f"ckpt_{step}")
        if checkpoint.latest_path(base) is not None:
            return base, step
    return None


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    from .. import resolve_device

    resolve_device(args.device)     # no card and no --device cpu: raise before any run
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    workdir = os.path.abspath(args.workdir)

    # ---- baseline: uninterrupted run
    base_log = os.path.join(workdir, "baseline.log")
    t0 = time.time()
    with open(base_log, "w") as f:
        p = run_segment(args, os.path.join(workdir, "baseline"), f)
        p.wait()
    if p.returncode != 0:
        raise RuntimeError(f"baseline failed ({p.returncode}); see {base_log}")
    base_final = final_loss(base_log)
    print(f"baseline: {args.steps} steps in {time.time() - t0:.1f}s, final loss {base_final}",
          flush=True)

    # ---- interrupted run
    out_dir = os.path.join(workdir, "crash")
    log1 = os.path.join(workdir, "crash_seg0.log")
    killed, in_flight, mid_save = None, [], False
    with open(log1, "w") as f:
        p = run_segment(args, out_dir, f)
        while p.poll() is None:
            if args.kill == "mid_save":
                in_flight = saves_in_flight(out_dir, 2 * args.bank)
                if in_flight:     # let the first save commit, kill during a later one
                    os.kill(p.pid, signal.SIGKILL)
                    break
            time.sleep(0.002)
        p.wait()
    if in_flight:
        # the .tmp outlives the kill only if the save had not swapped it in
        mid_save = all(os.path.isdir(t) for t in in_flight)
        killed = (f"SIGKILL {'mid-save' if mid_save else 'after the save'} "
                  f"({os.path.basename(in_flight[0])} present)")
    else:
        killed = (f"natural exit rc={p.returncode}" if p.returncode
                  else "completed uninterrupted")
    print(f"interruption: {killed}", flush=True)

    # ---- recovery: a fresh process resumes from the newest complete checkpoint
    t0 = time.time()
    found = newest_checkpoint(out_dir)
    if found is None:
        raise RuntimeError("no intact checkpoint survived the kill")
    resume, done = found
    print(f"intact checkpoint after kill: {resume} (step {done})", flush=True)
    log2 = os.path.join(workdir, "crash_seg1.log")
    with open(log2, "w") as f:
        p = run_segment(args, out_dir, f, resume=resume)
        p.wait()
    if p.returncode != 0:
        raise RuntimeError(f"recovery segment failed ({p.returncode}); see {log2}")
    with open(log2) as f:
        if "resuming from" not in f.read():
            raise RuntimeError("the recovery segment did not restore a checkpoint")
    # a run that ended by itself leaves its last checkpoint at --steps: nothing to redo
    rec_final = final_loss(log2) if done < args.steps else final_loss(log1)
    print(f"recovery: restored + {args.steps - done} steps in {time.time() - t0:.1f}s, "
          f"final loss {rec_final}", flush=True)

    rel = abs(rec_final - base_final) / max(abs(base_final), 1e-6)
    result = {
        "mode": "train_detector",
        "steps": args.steps,
        "interruption": killed,
        "killed_mid_save": mid_save,
        "banked_steps_at_kill": done,
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
