"""Associator training CLI (PyTorch port).

    python -m odam_torch.scripts.train_associator --config_path configs/detr_scan_net.yaml \\
        --tracks_dir data/ScanNet/track_pickles --steps 5000 --out_dir runs/assoc

Counterpart of ``scripts/train_associator.py`` with its flags and defaults,
on one device: the card unless ``--device cpu``.  The NLL of the
ground-truth matches is minimised with ``clip_by_global_norm(1) -> adam(1e-4)``
on the plain attention path (``use_kernels=False``), with no decode and no
host copy in the step.  ``--synthetic`` (or no ``--tracks_dir``) trains on
generated track histories.  Checkpoints and ``--resume_ckpt`` work as in
``train_detector``; ``run_processor --associator_ckpt`` reads them.
``--tracks_dir`` pickles are unpickled: load only trusted files.  Under a
launcher it trains data parallel over the ranks as ``train_detector`` does:
``--batch_size`` is the global batch, and each rank keeps its rows of it.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import numpy as np
import torch

from .. import config as config_mod

BATCH_KEYS = ("tracks", "track_mask", "detections", "det_mask", "gt_pairs", "pair_valid")


def synthetic_scenes(rng, n_scenes=4, n_tracks=6, n_frames=40):
    scenes = {}
    for s in range(n_scenes):
        tracks = []
        for t in range(n_tracks):
            n = int(rng.integers(min(10, n_frames - 1), n_frames))
            frames = np.sort(rng.choice(n_frames, n, replace=False))
            rows = np.full((n, 82), -1.0, np.float32)
            rows[:, 0] = frames
            rows[:, 1] = rng.integers(0, 8)
            rows[:, 2:6] = rng.uniform(0, 1, (n, 4))
            rows[:, 6:9] = rng.uniform(0.3, 2.0, 3) + rng.normal(0, 0.05, (n, 3))
            rows[:, 9:12] = rng.uniform(-3, 3, 3) + rng.normal(0, 0.05, (n, 3))
            rows[:, 12] = rng.uniform(-np.pi, np.pi) + rng.normal(0, 0.05, n)
            rows[:, 13] = rng.uniform(0.6, 1.0, n)
            tracks.append(rows)
        scenes[f"synthetic_{s}"] = tracks
    return scenes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.train_associator",
                                 description="Train the associator (PyTorch port).")
    ap.add_argument("--config_path", default="configs/detr_scan_net.yaml")
    ap.add_argument("--tracks_dir", default=None,
                    help="directory of per-scene track pickles (trusted files only)")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out_dir", default="runs/assoc")
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--save_every", type=int, default=1000)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--resume_ckpt", default=None,
                    help="a ckpt_<step> directory of an earlier run: continue at its step")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                    help="under a launcher: the process group's backend (default nccl on "
                         "the card, gloo on the CPU)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from ..parallel import distributed, mesh as mesh_mod

    device = distributed.init_distributed(backend=args.dist_backend, device=args.device)
    mesh = mesh_mod.make_mesh(device=device) if distributed.process_count() > 1 else None
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from ..data import datasets
    from ..models import associator as assoc_mod, convert
    from ..models import training as train_mod
    from ..utils import checkpoint, metrics

    cfg = config_mod.merge_cfg([args.config_path])
    acfg = assoc_mod.AssociatorConfig.from_cfg(cfg, use_kernels=False)

    rng = np.random.default_rng(0)
    if args.synthetic or not args.tracks_dir:
        scenes = synthetic_scenes(rng)
    else:
        scenes = {}
        for fn in sorted(os.listdir(args.tracks_dir)):
            with open(os.path.join(args.tracks_dir, fn), "rb") as f:
                data = pickle.load(f)
            scenes[fn] = data["tracks"] if isinstance(data, dict) else data
    ds = datasets.AssociatorDataset(scenes, max_tracks=32, max_dets=16, window=50)
    print(f"{len(ds)} association samples from {len(scenes)} scenes")

    params, opt_state, meta = None, None, {}
    if args.resume_ckpt:
        params, opt_state, meta = checkpoint.restore(args.resume_ckpt)
        print(f"resuming from {args.resume_ckpt} at step {meta.get('step', 0)}")
    model = assoc_mod.build_associator(acfg, flax_params=params, seed=0, device=device)
    opt = train_mod.make_assoc_optimizer(model, train_mod.AssocTrainConfig())
    if opt_state is not None:
        opt.load_state_arrays(opt_state)
    state = train_mod.init_train_state(model, opt, mesh)
    state.step = int(meta.get("step", 0))
    step_fn = train_mod.make_assoc_train_step(mesh)

    os.makedirs(args.out_dir, exist_ok=True)
    logger = None
    if distributed.is_main_process():
        logger = metrics.MetricLogger(os.path.join(args.out_dir, "train_log.jsonl"))
    batches = ds.batches(args.batch_size, rng)
    for _ in range(state.step):           # a resumed run continues the batch stream
        next(batches)
    t0 = time.time()
    for step in range(state.step, args.steps):
        batch = next(batches)
        b = [batch[k] for k in BATCH_KEYS]
        if mesh is not None:
            b = mesh_mod.shard_batch(b, mesh)
        loss = step_fn(state, *[torch.from_numpy(x).to(device) for x in b])   # global
        if (step + 1) % args.log_every == 0:
            seconds = distributed.reduce_scalars({"seconds": time.time() - t0})["seconds"]
            rate = args.log_every * args.batch_size / seconds
            t0 = time.time()
            if logger is not None:
                logger.log(step=step + 1, loss=float(loss), samples_per_sec=round(rate, 2))
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            distributed.save_on_main(
                checkpoint.save, os.path.join(args.out_dir, f"ckpt_{step + 1}"),
                convert.state_dict_to_flax(model), opt.state_arrays(),
                {"step": step + 1, "config_path": args.config_path})
    distributed.barrier()
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
