"""Recall-loss decomposition for the hard rehearsal.

    python -m odam_torch.examples.cli_rehearsal.diagnose_recall \\
        [--stages gt_full,gt_visible,oracle_det] [--associator_ckpt <weights>] [--device cpu]

Counterpart of ``examples/cli_rehearsal/diagnose_recall.py``, on the card
unless ``--device cpu``.  The full trained pipeline measured F1 0.556
(recall 0.417) while the benchmark's intrinsic recall ceiling
(``analyze_visibility``) is 0.792 at min_views=10.  This script attributes
the gap stage by stage by running the downstream pipeline on progressively
more idealized inputs:

  stage gt_full     GT instance tracks, every GT-listed frame (objects the
                    camera never really sees included) -> upper bound of
                    mapping + merge + eval under pose/observation noise.
  stage gt_visible  GT tracks restricted to frames where the object is
                    actually detectable (the oracle visibility criterion)
                    -> the mapping+eval bound a perfect detector+associator
                    could reach; should approach the 0.792 ceiling.
  stage oracle_det  Per-frame oracle detections (visible objects only,
                    mild noise) fed through the trained associator and
                    track store via ``runtime.offline.CachedDetectionPipeline``
                    -> adds association/tracking loss.  Each frame runs the
                    associator's GNN (fused_attention) and, with
                    ``--decode exact``, the LAP kernel.

``--associator_ckpt`` is a checkpoint directory of the port's trainer or a
Flax tree as ``.npz``; it defaults to the committed
``artifacts/torch/rehearsal_hard_assoc.npz``.  Each stage writes the CLI's
result pickles under ``--out`` (default ``runs/cli_rehearsal/result_hard/
diagnose``) and is scored by ``python -m odam_torch.scripts.eval_scan2cad``
in a subprocess against the committed hard split.  Compare each stage's
F1/recall with the full-pipeline ablation cell (adam_exact_sampled).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import torch

from .. import resolve
from . import hard
from .analyze_visibility import visible_flags
from .common import ASSOC_WEIGHTS, DATA_HARD, REPO, RUNS, load_params, make_assoc

DATA = DATA_HARD


def build_pipeline(associator_ckpt=None, decode="exact", device: str = "cuda"):
    """CachedDetectionPipeline with the rehearsal associator geometry on
    ``device`` (the port's seeded init without ``associator_ckpt``)."""
    from ...models import associator as assoc_mod
    from ...runtime import offline as offline_mod, processor as proc_mod

    dev = resolve(device)
    params = load_params(os.path.abspath(associator_ckpt)) if associator_ckpt else None
    assoc = assoc_mod.build_associator(dataclasses.replace(make_assoc(), decode=decode),
                                       flax_params=params, seed=1, device=dev)
    # capacities right-sized to the rehearsal (<=10 objects, 32 frames):
    # shapes are static, so the default 64x256 slots would cost 16x the
    # mapping FLOPs for identical results on these scenes
    pcfg = proc_mod.PipelineConfig(use_prior=True,
                                   representation="super_quadric",
                                   max_objs=24, max_views=64)
    return offline_mod.CachedDetectionPipeline(assoc, pcfg, device=dev)


def mapping_chain(pipe, tracks, frame_ids, T_wcs):
    """optim -> merge -> optim on explicit tracks (run_processor order)."""
    seq = pipe.sequence
    seq["usable_frames"] = [int(f) for f in frame_ids]
    seq["T_wcs"] = [np.asarray(T, np.float32) for T in T_wcs]
    seq["P_cws"] = [seq["K"][:3, :3] @ np.linalg.inv(T)[:3, :] for T in T_wcs]
    out = pipe.optim_process(tracks)
    merged = pipe.merge_process(out)
    return pipe.optim_process(merged)


def oracle_detections(seed, flags, noise, rng, max_dets=30, device: str = "cuda"):
    """Per-frame Detections a perfect detector would emit: every visible
    object, correct class, GT geometry + mild observation noise; the
    tensors on ``device``."""
    from ...models import detr as detr_mod

    dev = resolve(device)
    Kinv = np.linalg.inv(hard.K)
    per_frame = []
    for fid, T_wc, img, rows, inst_ids in hard.hard_scene_views(seed):
        valid = np.zeros((1, max_dets), bool)
        classes = np.zeros((1, max_dets), np.int32)
        scores = np.zeros((1, max_dets), np.float32)
        boxes = np.zeros((1, max_dets, 4), np.float32)
        dims = np.zeros((1, max_dets, 3), np.float32)
        t_co = np.zeros((1, max_dets, 3), np.float32)
        angle = np.zeros((1, max_dets), np.float32)
        j = 0
        for r, inst in zip(rows, inst_ids):
            if not flags[fid, int(inst)] or j >= max_dets:
                continue
            valid[0, j] = True
            classes[0, j] = int(r[0])
            scores[0, j] = 0.95
            bbox = np.array([r[1] - r[3] / 2, r[2] - r[4] / 2,
                             r[1] + r[3] / 2, r[2] + r[4] / 2]) * hard.IMG
            boxes[0, j] = bbox + rng.normal(0, noise * hard.IMG, 4)
            dims[0, j] = r[5:8] * np.exp(rng.normal(0, noise, 3))
            # projected center (px) + depth -> camera-frame center
            sc = (r[8:10] + r[1:3]) * hard.IMG
            z = r[10] * np.exp(rng.normal(0, noise))
            t_co[0, j] = z * (Kinv @ np.array([sc[0], sc[1], 1.0]))
            angle[0, j] = np.degrees(r[11] + rng.normal(0, noise))
            j += 1
        on = [torch.from_numpy(a).to(dev) for a in (valid, classes, scores, boxes, dims,
                                                    t_co, angle)]
        per_frame.append((fid, T_wc, detr_mod.Detections(
            *on, features=torch.zeros((1, max_dets, 1), dtype=torch.float32, device=dev))))
    return per_frame


def oracle_tracks(pipe, seed, noise, rng):
    """The oracle_det stage's tracking: every frame's oracle detections
    through ``pipe`` (the associator and the track store); its tracks."""
    _, flags, _, _ = visible_flags(seed)
    for fid, T_wc, dets in oracle_detections(seed, flags, noise, rng,
                                             device=pipe.device):
        pipe.process_detections(dets, fid, T_wc)
    return pipe.tracks


def run_stage(stage, out_root, noise, associator_ckpt, decode, device: str = "cuda",
              seeds=hard.EVAL_SEEDS):
    out_dir = os.path.join(out_root, stage)
    for seed in seeds:
        scene = hard.hard_scene_id(seed)
        rng = np.random.default_rng(7000 + seed)
        pipe = build_pipeline(
            associator_ckpt if stage == "oracle_det" else None, decode, device)
        pipe.init_sequence(hard.K, hard.IMG, hard.IMG)
        if stage in ("gt_full", "gt_visible"):
            keep = None
            if stage == "gt_visible":
                _, flags, _, _ = visible_flags(seed)
                keep = lambda fid, inst: bool(flags[fid, inst])  # noqa: E731
            tracks, poses = hard.hard_gt_world_tracks(
                seed, rng, noise=noise, keep=keep)
            fids = sorted(poses)
            out = mapping_chain(pipe, tracks, fids, [poses[f] for f in fids])
        elif stage == "oracle_det":
            out = pipe.optim_process(oracle_tracks(pipe, seed, noise, rng))
            merged = pipe.merge_process(out)
            out = pipe.optim_process(merged)
        else:
            raise ValueError(stage)
        os.makedirs(os.path.join(out_dir, scene), exist_ok=True)
        with open(os.path.join(out_dir, scene, scene), "wb") as f:
            pickle.dump({k: out[k] for k in
                         ("tracks", "bboxes_qc", "bboxes_dl", "quadrics")}, f)
        print(f"  {scene}: {len(out['tracks'])} final tracks", flush=True)

    ev = subprocess.run(
        [sys.executable, "-m", "odam_torch.scripts.eval_scan2cad",
         "--result_dir", out_dir,
         "--scan2cad", os.path.join(DATA, "full_annotations.json"),
         "--scans_root", os.path.join(DATA, "scans"),
         "--val_split", os.path.join(DATA, "val.txt"),
         "--min_views", "10"],
        cwd=REPO, capture_output=True, text=True,
    )
    if ev.returncode != 0:
        print(ev.stdout[-2000:], ev.stderr[-2000:])
        raise RuntimeError(f"eval failed for {stage}")
    m = re.search(r"average: precision ([0-9.]+) recall ([0-9.]+) F1 ([0-9.]+)",
                  ev.stdout)
    prec, rec, f1 = (float(x) for x in m.groups())
    print(f"{stage:>12}: F1 {f1:.3f}  precision {prec:.3f}  recall {rec:.3f}")
    return {"stage": stage, "f1": f1, "precision": prec, "recall": rec}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m odam_torch.examples.cli_rehearsal.diagnose_recall",
        description=__doc__.splitlines()[0])
    ap.add_argument("--stages", default="gt_full,gt_visible")
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--decode", default="exact", choices=["exact", "greedy"])
    ap.add_argument("--associator_ckpt", default=ASSOC_WEIGHTS)
    ap.add_argument("--out", default=os.path.join(RUNS, "result_hard", "diagnose"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve(args.device)
    results = [run_stage(s, args.out, args.noise, args.associator_ckpt,
                         args.decode, args.device)
               for s in args.stages.split(",")]
    print("\nsummary (compare with ablation adam_exact_sampled and the "
          "0.792 visibility ceiling):")
    for r in results:
        print(f"  {r['stage']:>12}: F1 {r['f1']:.3f} R {r['recall']:.3f} "
              f"P {r['precision']:.3f}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
