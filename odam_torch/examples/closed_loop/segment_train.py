"""One crash-isolated training segment of the synthetic closed loop.

    python -m odam_torch.examples.closed_loop.segment_train <seg> <steps> <ckpt> [--device cpu]

Counterpart of ``examples/closed_loop/segment_train.py``: segment ``seg``
trains the loop's DETR for ``steps`` steps at batch 8 on batches drawn from
``default_rng(seg)`` with a fresh optimizer (lr 5e-4 for every group, clip
5.0, no weight decay), starting from ``ckpt`` when it exists (else the
seeded init), and saves the parameters back to ``ckpt``, a checkpoint
directory of :mod:`odam_torch.utils.checkpoint` whose meta carries the
``global_step``.  The model trains on the plain attention path.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ...data.datasets import pack_targets
from ...models import convert, criterion as crit_mod, detr as detr_mod
from ...models import training as train_mod
from ...utils import checkpoint
from .. import resolve
from .closed_scene import make_detr, make_train_views, norm

BATCH = 8


def train_config() -> train_mod.DetrTrainConfig:
    return train_mod.DetrTrainConfig(lr=5e-4, lr_backbone=5e-4, clip_norm=5.0, weight_decay=0.0,
                                     criterion=crit_mod.CriterionConfig(num_classes=8))


def run_segment(model: detr_mod.DETR, seg: int, steps: int, views: list,
                batch: int = BATCH) -> dict:
    """Train ``model`` in place for one segment with a fresh optimizer;
    returns the last step's metrics (tensors on the model's device)."""
    dev = next(model.parameters()).device
    tcfg = train_config()
    state = train_mod.init_train_state(model, train_mod.make_detr_optimizer(model, tcfg))
    step_fn = train_mod.make_detr_train_step(tcfg)
    rng = np.random.default_rng(seg)  # distinct batches per segment
    m = {}
    for it in range(steps):
        idx = rng.integers(0, len(views), batch)
        imgs = torch.from_numpy(np.stack([norm(views[i][0]) for i in idx])).to(dev)
        targets = crit_mod.Targets(*[torch.from_numpy(x).to(dev) for x in
                                     pack_targets([views[i][1] for i in idx], 8)])
        state.step = seg * 10000 + it   # JAX's dropout key, jax.random.key(seg*10000+it)
        m = step_fn(state, imgs, targets)
    model.eval()
    return m


def segment_train(seg: int, steps: int, ckpt: str, device: str = "cuda",
                  batch: int = BATCH) -> dict:
    """Restore (or seed), train one segment, save; returns its loss, the
    checkpoint's ``global_step`` and the seconds it took."""
    device = resolve(device)
    params, meta = None, {}
    if checkpoint.latest_path(ckpt):
        params, _, meta = checkpoint.restore(ckpt)
        print(f"resumed from {ckpt}")
    model = detr_mod.build_detr(make_detr(use_kernels=False), flax_params=params, seed=0,
                                device=device)
    views = make_train_views()
    t0 = time.time()
    m = run_segment(model, seg, steps, views, batch)
    total = float(m["total"]) if m else float("nan")   # forces completion
    seconds = time.time() - t0
    global_step = int(meta.get("global_step", 0)) + steps
    checkpoint.save(ckpt, convert.state_dict_to_flax(model),
                    meta={"global_step": global_step, "seg": seg, "seg_steps": steps})
    print(f"segment {seg}: {steps} steps in {seconds:.0f}s, loss {total:.2f}")
    return {"seg": seg, "steps": steps, "loss": total, "global_step": global_step,
            "seconds": seconds}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.examples.closed_loop.segment_train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("seg", type=int)
    ap.add_argument("steps", type=int)
    ap.add_argument("ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return segment_train(args.seg, args.steps, args.ckpt, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
