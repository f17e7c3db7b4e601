"""Aggregate frames/s of scene-parallel lanes, the frames already on the device.

    python -m odam_torch.scripts.bench_scene_parallel [--lanes 1 2 4 8] [--passes 5]

Counterpart of ``scripts/bench_scene_parallel.py``: ``SceneParallelRunner``
(seeded weights at full width, ``--dtype``) at each lane count S, driving
``runner.step`` directly, as JAX drives ``runner._step``, over
device-resident normalized float32 frames ([S, H, W, 3], four of them
cycled, every lane at its own offset) and per-lane poses.  After a warm
block, ``--passes`` blocks of ``ODAM_BENCH_FRAMES`` (default 80) steps,
each closed by a synchronize: S x frames / seconds, the median of the
passes, and its ratio to the first lane count.  Both attention kernels
launch at B = S (the attention routes on each lane's batch, 1).  Runs on the
card unless ``--device cpu``; the first line names the device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.bench_scene_parallel",
                                 description="Aggregate frames/s of the lane-batched step "
                                             "(PyTorch port).")
    ap.add_argument("--lanes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--img_h", type=int, default=800)
    ap.add_argument("--img_w", type=int, default=1071)
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def pose(f: int, lane: int) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    phi = 0.02 * f + 0.7 * lane
    T[:3, :3] = np.array([[np.cos(phi), -np.sin(phi), 0],
                          [np.sin(phi), np.cos(phi), 0], [0, 0, 1]], np.float32)
    T[:3, 3] = [0.05 * f, 0.1 * lane, 1.4]
    return T


def main(argv: list[str] | None = None) -> dict:
    """Print each lane count's aggregate frames/s; return {S: [frames/s a pass]}."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from ..models import associator as assoc_mod, detr as detr_mod
    from ..runtime import processor as proc_mod, scene_parallel as sp_mod, tracker
    from ..utils.metrics import device_banner, synchronize

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    banner = device_banner(dev)
    print(f"device: {banner}", flush=True)
    img_h, img_w = args.img_h, args.img_w
    n_frames = int(os.environ.get("ODAM_BENCH_FRAMES", "80"))
    dtype = DTYPES[args.dtype]

    detr = detr_mod.build_detr(detr_mod.DETRConfig(dtype=dtype), seed=0, device=dev)
    assoc = assoc_mod.build_associator(assoc_mod.AssociatorConfig(dtype=dtype), seed=1,
                                       device=dev)
    pcfg = proc_mod.PipelineConfig(detect_threshold=0.0, score_threshold=0.0)
    rng = np.random.default_rng(0)
    frames_np = [rng.normal(0, 1, (img_h, img_w, 3)).astype(np.float32) for _ in range(4)]
    K = np.array([[1170.0 * img_w / 1296, 0, img_w / 2],
                  [0, 1170.0 * img_h / 968, img_h / 2],
                  [0, 0, 1]], np.float32)

    results = {}
    for S in args.lanes:
        runner = sp_mod.SceneParallelRunner(detr, assoc, pcfg, S, device=dev)
        stores = tracker.init_store_lanes(S, pcfg.max_tracks, pcfg.window, dev)
        logs = tracker.init_log_lanes(S, pcfg.max_log_frames, pcfg.max_dets, dev)
        Ks = torch.from_numpy(np.stack([K] * S)).to(dev)
        dev_frames = [torch.from_numpy(np.stack([frames_np[(f + lane) % 4]
                                                 for lane in range(S)])).to(dev)
                      for f in range(4)]

        def run_block(f0, stores, logs):
            meta = np.zeros((S, 18), np.float32)
            meta[:, 17] = 1.0
            for f in range(f0, f0 + n_frames):
                meta[:, 0] = f
                meta[:, 1:17] = np.stack([pose(f, lane).reshape(16) for lane in range(S)])
                res = runner.step(stores, logs, dev_frames[f % 4], meta, Ks, img_h, img_w)
                stores, logs = res.store, res.log
            return stores, logs

        t0 = time.perf_counter()
        stores, logs = run_block(0, stores, logs)
        synchronize(dev)
        print(f"S={S}: warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        fps = []
        for rep in range(args.passes):
            t0 = time.perf_counter()
            stores, logs = run_block(n_frames * (rep + 1), stores, logs)
            synchronize(dev)
            fps.append(S * n_frames / (time.perf_counter() - t0))
        results[S] = fps
        print(f"S={S}: aggregate median {np.median(fps):.2f} fps "
              f"[{', '.join(f'{x:.1f}' for x in fps)}]", flush=True)

    base = np.median(results[args.lanes[0]])
    for S, fps in results.items():
        print(f"S={S}: {np.median(fps):.2f} fps aggregate "
              f"({np.median(fps) / base:.2f}x vs S={args.lanes[0]})")
    return {"device": banner, "fps": results, "frames_per_pass": n_frames,
            "passes": args.passes}


if __name__ == "__main__":
    main()
