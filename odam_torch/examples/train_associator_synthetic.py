"""Example: train the associator from scratch on synthetic tracks and
evaluate matching precision / recall / F1 on held-out scenes.

    python -m odam_torch.examples.train_associator_synthetic [--device cpu]

Counterpart of ``examples/train_associator_synthetic.py``: the same scenes,
dataset, 400 Adam steps (clip 1.0, lr 3e-4) at batch 16, and
``eval.association.evaluate_scene`` before and after.  The model trains on
the plain attention path; the evaluation runs a copy of it with the
attention kernels and the exact decode (the LAP kernel on the card).
:func:`run` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from . import resolve
from ..data import datasets
from ..eval import association
from ..models import associator as assoc_mod, training as train_mod
from ..scripts.train_associator import BATCH_KEYS, synthetic_scenes

CONFIG = assoc_mod.AssociatorConfig(
    descriptor_dim=64, keypoint_encoder=(78, 64, 64),
    gnn_layers=("self", "cross", "self", "cross"), self_gnn_layers=("self",),
    sinkhorn_iterations=30, use_kernels=False,
)
SAMPLE = dict(max_tracks=8, max_dets=6, window=12)


def data():
    """(train scenes, test scenes, the dataset, the rng the batches continue)."""
    rng = np.random.default_rng(0)
    train_sc = synthetic_scenes(rng, n_scenes=6, n_tracks=5, n_frames=30)
    test_sc = synthetic_scenes(np.random.default_rng(99), n_scenes=2, n_tracks=5, n_frames=30)
    return train_sc, test_sc, datasets.AssociatorDataset(train_sc, **SAMPLE), rng


def evaluate(model: assoc_mod.Associator, tracks) -> association.AssociationMetrics:
    """``evaluate_scene`` with a copy of ``model`` on the attention kernels."""
    dev = next(model.parameters()).device
    kernel_model = assoc_mod.build_associator(
        dataclasses.replace(model.config, use_kernels=True), device=dev)
    kernel_model.load_state_dict(model.state_dict())
    return association.evaluate_scene(kernel_model, tracks, **SAMPLE)


def run(device: str = "cuda", steps: int = 400, verbose: bool = True) -> dict:
    """Train from the port's seeded init and evaluate."""
    dev = resolve(device)
    train_sc, test_sc, ds, rng = data()
    if verbose:
        print(f"{len(ds)} train samples")
    model = assoc_mod.build_associator(CONFIG, seed=0, device=dev)
    opt = train_mod.make_assoc_optimizer(model, train_mod.AssocTrainConfig(lr=3e-4,
                                                                           clip_norm=1.0))
    state = train_mod.init_train_state(model, opt)
    step_fn = train_mod.make_assoc_train_step()

    # baseline F1 (random weights)
    m0 = evaluate(model, test_sc["synthetic_0"])
    if verbose:
        print(f"before training: P {m0.precision:.2f} R {m0.recall:.2f} F1 {m0.f1:.2f}")

    batches = ds.batches(16, rng)
    nll, t0 = {}, time.time()
    for it in range(steps):
        b = next(batches)
        loss = step_fn(state, *[torch.from_numpy(b[k]).to(dev) for k in BATCH_KEYS])
        if (it + 1) % 100 == 0 or it + 1 == steps:
            nll[it + 1] = float(loss)
            if verbose:
                print(f"step {it + 1}: nll {nll[it + 1]:.3f} ({time.time() - t0:.0f}s)")
    seconds = time.time() - t0
    model.eval()
    after = {}
    for name, tracks in test_sc.items():
        m = evaluate(model, tracks)
        after[name] = {"precision": m.precision, "recall": m.recall, "f1": m.f1,
                       "n_frames": m.n_frames}
        if verbose:
            print(f"{name}: P {m.precision:.3f} R {m.recall:.3f} F1 {m.f1:.3f} "
                  f"({m.n_frames} frames)")
    return {"before": {"precision": m0.precision, "recall": m0.recall, "f1": m0.f1},
            "after": after, "nll": nll, "train_seconds": seconds, "model": model}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.train_associator_synthetic",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main(sys.argv[1:])
