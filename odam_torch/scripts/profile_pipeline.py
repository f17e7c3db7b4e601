"""Per-stage profile of the online step, and of the composed step.

    python -m odam_torch.scripts.profile_pipeline [--h 800 --w 1071] [--trace DIR]

Counterpart of ``scripts/profile_pipeline.py``, with seeded weights at full
width (``DETRConfig()``, ``AssociatorConfig()`` in ``--dtype``): the DETR
forward, postprocess + NMS, the track re-projection and the associator
forward, each alone in steady state (``--iters`` calls closed by a
synchronize, after one warm call), then ``OdamPipeline.process_frame`` over
``--frames`` frames after two warm frames.  ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of 5 more frames there
(:func:`odam_torch.utils.metrics.profiler_trace`).  At batch 1 the DETR's
attention takes both kernels (flash at its 850 image tokens, fused in the
decoder's self-attention) and the associator's GNN the fused one.

Runs on the card unless ``--device cpu``; the first line names the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.profile_pipeline",
                                 description="Per-stage timing of the online step "
                                             "(PyTorch port).")
    ap.add_argument("--h", type=int, default=800)
    ap.add_argument("--w", type=int, default=1071)
    ap.add_argument("--trace", default=None, help="write a torch.profiler trace here")
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--iters", type=int, default=10, help="calls a stage is timed over")
    ap.add_argument("--frames", type=int, default=30, help="frames the composed step runs")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Print one line a stage; return {stage: ms} and the trace's path."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from ..models import associator as assoc_mod, detr as detr_mod
    from ..runtime import processor as proc_mod, tracker
    from ..utils.metrics import device_banner, profiler_trace, synchronize, time_ms

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = DTYPES[args.dtype]
    print(f"device: {device_banner(dev)}  input {args.h}x{args.w}  {args.dtype}", flush=True)

    detr = detr_mod.build_detr(detr_mod.DETRConfig(dtype=dtype), seed=0, device=dev)
    assoc = assoc_mod.build_associator(assoc_mod.AssociatorConfig(dtype=dtype), seed=1,
                                       device=dev)
    pcfg = proc_mod.PipelineConfig(detect_threshold=0.0, score_threshold=0.0)
    K = torch.tensor([[500.0, 0, args.w / 2], [0, 500, args.h / 2], [0, 0, 1]], device=dev)
    img = torch.zeros((1, args.h, args.w, 3), device=dev)
    stages = {}

    def stage(name, fn):
        stages[name] = time_ms(fn, args.iters, dev)
        print(f"{name + ':':<20} {stages[name]:8.2f} ms", flush=True)

    with torch.no_grad():
        out = detr(img)
        stage("detr forward", lambda: detr(img))
        stage("postprocess + NMS",
              lambda: detr_mod.postprocess(out, float(args.w), float(args.h), 0.6, K))
        store = tracker.init_store(pcfg.max_tracks, pcfg.window, dev)
        T_wc = torch.eye(4, device=dev)
        stage("track re-projection",
              lambda: proc_mod.prepare_track_inputs(store, T_wc, K, float(args.w),
                                                    float(args.h), pcfg.track_bbox_samples))
        tr = torch.full((1, pcfg.max_tracks, pcfg.window, 79), -1.0, device=dev)
        tm = torch.zeros((1, pcfg.max_tracks), dtype=torch.bool, device=dev)
        tm[:, :10] = True
        de = torch.full((1, pcfg.max_dets, 79), -1.0, device=dev)
        dm = torch.zeros((1, pcfg.max_dets), dtype=torch.bool, device=dev)
        dm[:, :10] = True
        stage("associator forward", lambda: assoc(tr, tm, de, dm))

    pipe = proc_mod.OdamPipeline(detr, assoc, pcfg, device=dev)
    pipe.init_sequence(K.cpu().numpy(), args.h, args.w)
    frame = np.zeros((args.h, args.w, 3), np.uint8)
    eye = np.eye(4, dtype=np.float32)
    for f in range(2):
        pipe.process_frame(frame, f, eye)
    synchronize(dev)
    t0 = time.perf_counter()
    for f in range(2, 2 + args.frames):
        pipe.process_frame(frame, f, eye)
    synchronize(dev)
    dt = (time.perf_counter() - t0) / args.frames * 1000
    stages["composed step"] = dt
    print(f"composed step (async, incl. H2D): {dt:8.2f} ms  ({1000 / dt:.1f} fps)", flush=True)

    trace = None
    if args.trace:
        with profiler_trace(args.trace):
            for f in range(40, 45):
                pipe.process_frame(frame, f, eye)
            synchronize(dev)
        print(f"trace written to {args.trace}", flush=True)
        trace = args.trace
    return {"device": device_banner(dev), "stages_ms": stages, "trace_dir": trace}


if __name__ == "__main__":
    main()
