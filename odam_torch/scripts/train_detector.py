"""Detector training CLI (PyTorch port).

    python -m odam_torch.scripts.train_detector --config_path configs/detr_scan_net.yaml \\
        --annotations data/ScanNet/imovotenet_scan2cad/train.json \\
        --batch_size 8 --steps 10000 --out_dir runs/detr

Counterpart of ``scripts/train_detector.py`` with its flags and defaults, on
one device: the card unless ``--device cpu``.  The model trains on the plain
attention path (``use_kernels=False``: the kernels have no backward, and
JAX's script trains without ``use_pallas`` too) in ``--dtype`` (bfloat16 by
default, float32 parameters).  ``--synthetic`` (or no ``--annotations``)
trains on generated batches.  Every ``--save_every`` steps and at the end it
writes ``<out_dir>/ckpt_<step>/`` (:mod:`odam_torch.utils.checkpoint`):
``run_processor --detector_ckpt`` reads that directory, and
``--resume_ckpt`` continues from it at its step, with its optimizer state,
up to ``--steps`` in all.  The log goes to ``<out_dir>/train_log.jsonl``.

Under a launcher (``python -m torch.distributed.run --nproc_per_node W -m
odam_torch.scripts.train_detector ...``) it trains data parallel over the W
ranks (:mod:`odam_torch.models.training`): ``--batch_size`` stays the global
batch, as in JAX; every rank draws the same global batch from the same
seeded stream and keeps its rows, so W ranks train on what one process
trains on.  ``--dist_backend`` is ``nccl`` (a card a rank, the default on
the card) or ``gloo`` (the CPU's default; ranks may share a card).  Rank 0
writes the log and the checkpoints; ``--resume_ckpt`` is read on every rank.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import config as config_mod


def synthetic_batches(batch_size, h, w, num_classes, max_objects, rng):
    from ..data.datasets import pack_targets

    while True:
        images = rng.normal(size=(batch_size, h, w, 3)).astype(np.float32)
        objs = []
        for _ in range(batch_size):
            n = rng.integers(1, max_objects + 1)
            rows = np.zeros((n, 12), np.float32)
            rows[:, 0] = rng.integers(0, num_classes, n)
            rows[:, 1:5] = rng.uniform(0.2, 0.6, (n, 4))
            rows[:, 5:8] = rng.uniform(0.3, 2.0, (n, 3))
            rows[:, -2] = rng.uniform(0.5, 5.0, n)
            rows[:, -1] = rng.uniform(-np.pi, np.pi, n)
            objs.append(rows)
        yield images, pack_targets(objs, max_objects)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.train_detector",
                                 description="Train the DETR detector (PyTorch port).")
    ap.add_argument("--config_path", default="configs/detr_scan_net.yaml")
    ap.add_argument("--annotations", default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--img_h", type=int, default=512)
    ap.add_argument("--img_w", type=int, default=672)
    ap.add_argument("--out_dir", default="runs/detr")
    ap.add_argument("--save_every", type=int, default=1000)
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
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
        # float32 means float32: cuDNN runs convolutions in TF32 by default
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from ..data import datasets
    from ..models import convert, criterion as crit_mod, detr as detr_mod
    from ..models import training as train_mod
    from ..utils import checkpoint, metrics

    cfg = config_mod.merge_cfg([args.config_path])
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    dcfg = detr_mod.DETRConfig.from_cfg(cfg, dtype=dtype, use_kernels=False)
    params, opt_state, meta = None, None, {}
    if args.resume_ckpt:
        params, opt_state, meta = checkpoint.restore(args.resume_ckpt)
        print(f"resuming from {args.resume_ckpt} at step {meta.get('step', 0)}")
    model = detr_mod.build_detr(dcfg, flax_params=params, seed=0, device=device)
    tcfg = train_mod.DetrTrainConfig(
        lr=float(cfg.get("lr", 1e-4)), lr_backbone=float(cfg.get("lr_backbone", 1e-5)),
        criterion=crit_mod.CriterionConfig(num_classes=dcfg.num_classes,
                                           eos_coef=float(cfg.get("eos_coef", 0.1))))
    opt = train_mod.make_detr_optimizer(model, tcfg)
    if opt_state is not None:
        opt.load_state_arrays(opt_state)
    state = train_mod.init_train_state(model, opt, mesh)
    state.step = int(meta.get("step", 0))
    step_fn = train_mod.make_detr_train_step(tcfg, mesh=mesh)

    rng = np.random.default_rng(0)
    if args.synthetic or not args.annotations:
        batches = synthetic_batches(args.batch_size, args.img_h, args.img_w, dcfg.num_classes,
                                    8, rng)
    else:
        ds = datasets.DetectorDataset(args.annotations)
        batches = ds.batches(args.batch_size, args.img_h, args.img_w, rng)
    for _ in range(state.step):           # a resumed run continues the batch stream
        next(batches)

    os.makedirs(args.out_dir, exist_ok=True)
    logger = None
    if distributed.is_main_process():
        logger = metrics.MetricLogger(os.path.join(args.out_dir, "train_log.jsonl"))
    t0 = time.time()
    for step in range(state.step, args.steps):
        images, targets = next(batches)
        if mesh is not None:
            images, targets = mesh_mod.shard_batch((images, targets), mesh)
        images = torch.from_numpy(images).to(device)
        targets = crit_mod.Targets(*[torch.from_numpy(x).to(device) for x in targets])
        m = step_fn(state, images, targets)           # the global batch's metrics
        if (step + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in m.items() if not k[-1].isdigit()}
            seconds = distributed.reduce_scalars({"seconds": time.time() - t0})["seconds"]
            rate = args.log_every * args.batch_size / seconds
            t0 = time.time()
            if logger is not None:
                logger.log(step=step + 1, imgs_per_sec=round(rate, 2), **m)
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            distributed.save_on_main(
                checkpoint.save, os.path.join(args.out_dir, f"ckpt_{step + 1}"),
                convert.state_dict_to_flax(model), opt.state_arrays(),
                {"step": step + 1, "config_path": args.config_path, "dtype": args.dtype})
    distributed.barrier()
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
