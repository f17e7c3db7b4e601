"""Validate the committed trained rehearsal weights.

    python -m odam_torch.artifacts.validate [--assoc <weights>] [--detr <weights>] [--device cpu]

Counterpart of ``artifacts/validate.py``, on the card unless ``--device
cpu``.  It reads the committed ``artifacts/torch/rehearsal_hard_{assoc,
detr}.npz`` (the orbax checkpoints of ``artifacts/`` as Flax trees) by
default, or a checkpoint directory of the port's trainer, and measures them
on a deterministic held-out stream (``hard.EVAL_SEEDS``: layout seeds the
training never draws), so that recommitted weights can be shown to be the
models the docs describe without rerunning the ablation chain:

- associator: mean association NLL over the eval scenes' domain-matched
  stream (visibility-gated GT tracks; the sample geometry of the rehearsal
  trainer's associator mode), batches of 8.  The complete 800-step
  weights measure ~0.10-0.15 (JAX: 0.145); above 0.5 means wrong or
  truncated weights.
- detector: per-frame visible-object recall / class accuracy through
  ``probe_detector.stats`` on 8 frames of each eval layout.  The recall is
  pinned at 0.84 for a complete model (18,000 steps).  "Complete" is read
  from the meta: a checkpoint directory's ``global_step``; a ``.npz`` has
  no meta, so the committed ``rehearsal_hard_detr.npz`` takes the
  ``global_step`` of the orbax checkpoint it was converted from
  (``artifacts/rehearsal_hard_detr_ckpt/odam_meta.json``: 18,000), and any
  other ``.npz`` has none: its recall is reported, not pinned.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..examples import resolve
from ..examples.cli_rehearsal.common import (ASSOC_WEIGHTS, DETR_WEIGHTS, REPO, load_params,
                                             make_assoc)

ASSOC = ASSOC_WEIGHTS
DETR = DETR_WEIGHTS
# the meta of the orbax checkpoint each committed .npz was converted from
NPZ_META = {DETR_WEIGHTS: os.path.join(REPO, "artifacts", "rehearsal_hard_detr_ckpt",
                                       "odam_meta.json")}

# Recall pin for the complete (18k-step) detector: the finished model must
# score near its documented operating point.  Partial checkpoints are
# only reported.
FULL_STEPS = 18000
RECALL_PIN = 0.84


def _meta(path: str) -> dict | None:
    from ..utils import checkpoint

    if os.path.isdir(path):
        return checkpoint.load_meta(path)
    meta = NPZ_META.get(os.path.abspath(path))
    if meta is None or not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)


def association_samples() -> list[dict]:
    """The held-out association samples of the eval layouts, in JAX's order."""
    from ..data.datasets import build_association_sample
    from ..examples.cli_rehearsal import analyze_visibility as av
    from ..examples.cli_rehearsal.hard import EVAL_SEEDS, IMG, hard_gt_world_tracks

    T, N, W, P = 16, 30, 100, 32
    samples = []
    for seed in EVAL_SEEDS:
        _, flags, _, _ = av.visible_flags(seed)

        def keep(fid, inst, flags=flags):
            return bool(flags[fid, inst])

        tracks, poses = hard_gt_world_tracks(
            seed, np.random.default_rng(seed), noise=0.05, keep=keep)
        srng = np.random.default_rng(2000 + seed)
        for t in tracks:
            t[:, 13] = srng.uniform(0.6, 1.0, len(t))
        for fid, T_wc in poses.items():
            if fid == 0:
                continue
            s = build_association_sample(
                tracks, float(fid), T, N, W, T_wc=T_wc,
                img_w=float(IMG), img_h=float(IMG))
            if s is None:
                continue
            pairs = np.zeros((P, 2), np.int32)
            valid = np.zeros((P,), bool)
            k = min(len(s["gt_pairs"]), P)
            pairs[:k] = s["gt_pairs"][:k]
            valid[:k] = True
            s["gt_pairs"], s["pair_valid"] = pairs, valid
            samples.append(s)
    return samples


def eval_associator(weights: str = ASSOC, device: str = "cuda") -> float:
    from ..models import associator as assoc_mod

    dev = resolve(device)
    samples = association_samples()
    model = assoc_mod.build_associator(make_assoc(), flax_params=load_params(weights),
                                       device=dev)

    def nll(tracks, track_mask, dets, det_mask, gt_pairs, pair_valid):
        out = model(tracks, track_mask, dets, det_mask)
        n = torch.clamp(pair_valid.sum(), min=1)
        return assoc_mod.association_nll(
            out.log_assignment, gt_pairs, pair_valid) / n

    keys = ("tracks", "track_mask", "detections", "det_mask",
            "gt_pairs", "pair_valid")
    assert len(samples) >= 8, (
        f"only {len(samples)} eval association samples materialized; the "
        "held-out stream is broken (not the checkpoint) — np.mean over zero "
        "batches would NaN the NLL assertion")
    vals = []
    with torch.no_grad():
        for i in range(0, len(samples) - 7, 8):
            batch = [torch.from_numpy(np.stack([samples[j][k] for j in range(i, i + 8)])).to(dev)
                     for k in keys]
            vals.append(float(nll(*batch)))
    return float(np.mean(vals))


def eval_detector(weights: str = DETR, device: str = "cuda"):
    """The probe's counts on the eval views, recall and class accuracy, and
    the weights' ``global_step`` (None without meta); None without weights."""
    from ..examples.cli_rehearsal import probe_detector
    from ..examples.cli_rehearsal.hard import EVAL_SEEDS
    from ..utils import checkpoint

    if not (checkpoint.latest_path(weights) if os.path.isdir(weights)
            else os.path.isfile(weights)):
        return None
    model = probe_detector.load_detector(weights, device)
    tp, ce, fn, fp = probe_detector.stats(
        model, EVAL_SEEDS, n_frames=8, visible_only=True)
    rec = (tp + ce) / max(tp + ce + fn, 1)
    acc = tp / max(tp + ce, 1)
    meta = _meta(weights) or {}
    return {"recall": round(rec, 3), "class_acc": round(acc, 3),
            "tp": tp, "cls_err": ce, "fn": fn, "fp": fp,
            "global_step": meta.get("global_step")}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.artifacts.validate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--assoc", default=ASSOC, help="associator weights (.npz or a checkpoint)")
    ap.add_argument("--detr", default=DETR, help="detector weights (.npz or a checkpoint)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve(args.device)
    nll = eval_associator(args.assoc, args.device)
    print(f"associator eval-stream NLL: {nll:.3f} (expect ~0.10-0.15; fail > 0.5)")
    assert nll < 0.5, "committed associator checkpoint does not match its docs"

    det = eval_detector(args.detr, args.device)
    if det is None:
        print("detector checkpoint absent (segments not yet committed)")
    else:
        print(f"detector probe on eval views: {det}")
        if (det["global_step"] or 0) >= FULL_STEPS:
            assert det["recall"] >= RECALL_PIN, (
                f"complete detector checkpoint scores visible-recall "
                f"{det['recall']} < {RECALL_PIN}: not the model the docs "
                f"describe (MEASURED.md operating point)")
        else:
            print(f"  (partial checkpoint at {det['global_step']}/"
                  f"{FULL_STEPS} steps: recall reported, not pinned)")
    print("ARTIFACT VALIDATION OK")
    return {"associator_nll": nll, "detector": det}


if __name__ == "__main__":
    main(sys.argv[1:])
