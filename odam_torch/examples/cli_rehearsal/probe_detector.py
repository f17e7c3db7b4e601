"""Held-out detection-quality probe for the hard rehearsal detector.

    python -m odam_torch.examples.cli_rehearsal.probe_detector [weights] [--train] [--device cpu]

Counterpart of ``examples/cli_rehearsal/probe_detector.py``: runs a detector
over eval-layout frames (and with ``--train`` train layouts) and reports
per-frame recall / class accuracy / false positives, the fast diagnostic
that separates layout memorization from generalization.  ``weights`` is a
checkpoint directory of the port's trainer or a Flax tree as ``.npz``
(default: the committed ``artifacts/torch/rehearsal_hard_detr.npz``).  The
detector runs with the attention kernels (TinyBackbone, stage 3 at 192x192:
144 image tokens).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve
from ...models import detr as detr_mod
from .common import DETR_WEIGHTS as WEIGHTS, load_params, make_detr, norm
from .hard import EVAL_SEEDS, hard_scene_views


def load_detector(path: str = WEIGHTS, device: str = "cuda") -> detr_mod.DETR:
    """The hard rehearsal DETR with the weights at ``path`` (a checkpoint
    directory or a ``.npz`` Flax tree)."""
    dev = resolve(device)
    return detr_mod.build_detr(make_detr(16, backbone_stage=3, backbone="tiny"),
                               flax_params=load_params(path), device=dev)


def stats(model: detr_mod.DETR, seeds, phase=0.0, n_frames=16, thresh=0.6,
          visible_only=False):
    """Per-frame detection stats vs GT rows: (tp, cls_err, fn, fp).

    ``visible_only`` restricts GT to rows passing the detectability gate
    (``analyze_visibility.visible_flags``) — the fair recall metric, since
    GT rows list every projectable object including fully overpainted ones.
    A detection matching only an invisible row still counts as fp in this
    mode (it IS a hallucination).
    """
    dev = next(model.parameters()).device
    flags = {}
    if visible_only:
        from .analyze_visibility import visible_flags

        for seed in seeds:
            flags[seed] = visible_flags(seed)[1]
    tp = fp = fn = cls_err = 0
    for seed in seeds:
        for fid, T, img, rows, inst in hard_scene_views(seed, phase=phase)[:n_frames]:
            if visible_only and phase == 0.0:
                keep_rows = [r for r, i in zip(rows, inst) if flags[seed][fid, int(i)]]
            else:
                keep_rows = list(rows)
            with torch.no_grad():
                out = model(torch.from_numpy(norm(img))[None].to(dev))
            logits = out["pred_logits"][0].float().cpu().numpy()
            boxes = out["pred_boxes"][0].float().cpu().numpy()
            prob = np.exp(logits - logits.max(-1, keepdims=True))
            prob /= prob.sum(-1, keepdims=True)
            keep = prob[:, :-1].max(-1) > thresh
            dets = [(int(prob[q, :-1].argmax()), boxes[q, :2])
                    for q in range(len(keep)) if keep[q]]
            used = set()
            for r in keep_rows:
                gcls, gc = int(r[0]), r[1:3]
                best, bestd = None, 0.08
                for j, (dcls, dc) in enumerate(dets):
                    if j in used:
                        continue
                    d = np.linalg.norm(dc - gc)
                    if d < bestd:
                        best, bestd = j, d
                if best is None:
                    fn += 1
                else:
                    used.add(best)
                    if dets[best][0] == gcls:
                        tp += 1
                    else:
                        cls_err += 1
            fp += len(dets) - len(used)
    return tp, cls_err, fn, fp


def _line(counts) -> str:
    tp, ce, fn, fp = counts
    rec = (tp + ce) / max(tp + ce + fn, 1)
    acc = tp / max(tp + ce, 1)
    return f"tp {tp} cls_err {ce} fn {fn} fp {fp} | recall {rec:.3f} class_acc {acc:.3f}"


def probe(weights: str = WEIGHTS, device: str = "cuda", train: bool = False) -> dict:
    """The probe's counts: ``all`` GT rows and ``visible`` only over the eval
    layouts, and the train-range layouts with ``train``."""
    model = load_detector(weights, device)
    out = {"all": stats(model, EVAL_SEEDS), "visible": stats(model, EVAL_SEEDS, visible_only=True)}
    print(f"eval layouts (all GT rows):   {_line(out['all'])}")
    print(f"eval layouts (visible only):  {_line(out['visible'])}")
    if train:
        out["train"] = stats(model, (100, 101, 102))
        tp, ce, fn, fp = out["train"]
        print(f"train-range layouts: tp {tp} cls_err {ce} fn {fn} fp {fp}")
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.cli_rehearsal.probe_detector",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("weights", nargs="?", default=WEIGHTS)
    ap.add_argument("--train", action="store_true", help="also the train-range layouts")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return probe(args.weights, args.device, train=args.train)


if __name__ == "__main__":
    main(sys.argv[1:])
