"""Where the batched detector's time goes: stage knockout timing, with MFU.

    python -m odam_torch.scripts.profile_batched_detector [--batch 16] [--passes 5] [--per_stage]

Counterpart of ``scripts/profile_batched_detector.py``.  Three programs on
the same [B, H, W, 3] input, each timed as the median of ``--passes``
passes of ``--reps`` calls closed by a synchronize:

  backbone     ResNet-50 -> stage-4 features (the FLOP bulk)
  detr_fwd     the DETR forward (backbone + input-proj + transformer + heads)
  full         the forward and postprocess (NMS, top-k)

transformer+heads = detr_fwd - backbone; postprocess = full - detr_fwd.
Each stage gets its analytic FLOPs (the counters of
:mod:`.bench_batched_detection`), achieved TFLOP/s and MFU against the
H100's dense peak for the dtype (989 TFLOP/s bf16, 67 f32 with TF32 off).
``--per_stage`` also attributes the backbone per stage by prefix knockout:
prefix(0) is the stem conv alone (``--stem``'s: the literal conv,
``resnet.stem_s2d`` or ``resnet.stem_im2col``), prefix(k) a ResNet asked for
stage k only, which stops there (``ResNet.forward``); stage k's time is
prefix(k) - prefix(k-1).  ``--pallas on|off`` is the attention kernels'
switch (``use_kernels``), as ``run_processor --use_pallas``.
``--trace_dir`` writes a ``torch.profiler`` trace of one full call.  Runs
on the card unless ``--device cpu``; the first line names the device, and
a CPU run prints no MFU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from .bench_batched_detection import (PEAK_TFLOPS, conv_flops_per_stage, conv_flops_resnet50,
                                      transformer_heads_flops)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STAGES = ("stem", "layer1", "layer2", "layer3", "layer4")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.profile_batched_detector",
                                 description="Stage attribution of the batched detector "
                                             "(PyTorch port).")
    ap.add_argument("--batch", type=int, nargs="+", default=[16])
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10, help="calls per timed pass")
    ap.add_argument("--trace_dir", default=None)
    ap.add_argument("--pallas", choices=["on", "off"], default="on",
                    help="the attention kernels on or off (use_kernels)")
    ap.add_argument("--stem", choices=["conv", "s2d", "im2col"], default="conv",
                    help="backbone stem: the literal 7x7/s2 conv, the space-to-depth "
                         "rewrite or the patch-matrix matmul (same math, same weights)")
    ap.add_argument("--per_stage", action="store_true",
                    help="also attribute the backbone per stage (stem + layer1..4) by "
                         "cumulative-prefix knockout")
    ap.add_argument("--img_h", type=int, default=800)
    ap.add_argument("--img_w", type=int, default=1071)
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Print the attribution; return, a batch, the stage and prefix times (ms),
    TFLOP/s and MFU (None on the CPU)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from ..models import detr as detr_mod, resnet
    from ..runtime import processor as proc_mod
    from ..utils.metrics import device_banner, profiler_trace, synchronize

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    img_h, img_w = args.img_h, args.img_w
    dtype = DTYPES[args.dtype]
    peak = PEAK_TFLOPS[args.dtype]
    banner = device_banner(dev)
    print(f"device: {banner} image {img_h}x{img_w} dtype {args.dtype} peak {peak} TFLOP/s",
          flush=True)

    dcfg = detr_mod.DETRConfig(dtype=dtype, use_kernels=args.pallas == "on", aux_loss=False,
                               stem=args.stem)
    model = detr_mod.build_detr(dcfg, seed=0, device=dev)
    pcfg = proc_mod.PipelineConfig()
    K = torch.tensor([[1170.0, 0, img_w / 2], [0, 1170.0, img_h / 2], [0, 0, 1]], device=dev)
    stage_k = dcfg.backbone_stage

    def stage_backbone(x):
        return model.backbone(x.permute(0, 3, 1, 2))[stage_k]

    def stage_fwd(x):
        return model(x)["pred_logits"]

    def stage_full(x):
        return detr_mod.postprocess(model(x), float(img_w), float(img_h),
                                    pcfg.detect_threshold, K, max_dets=pcfg.max_dets).scores

    def median_ms(fn, x, name):
        t0 = time.perf_counter()
        fn(x)
        synchronize(dev)
        print(f"B={x.shape[0]} {name}: warm {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        times = []
        for _ in range(args.passes):
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn(x)
            synchronize(dev)
            times.append((time.perf_counter() - t0) / args.reps)
        return float(np.median(times))

    def rate(fl, t):
        tf = fl / t / 1e12
        return tf, (100 * tf / peak if dev.type == "cuda" else None)

    def mfu_text(mfu):
        return "MFU not measured (cpu)" if mfu is None else f"MFU {mfu:5.1f}%"

    # analytic FLOPs per frame
    L = (img_h // 32) * (img_w // 32)
    conv_f, _ = conv_flops_resnet50(img_h, img_w)
    proj_f = 2 * L * 2048 * dcfg.hidden_dim
    tr_f = transformer_heads_flops(L, dcfg.num_queries, dcfg.hidden_dim, dcfg.dim_feedforward,
                                   dcfg.enc_layers, dcfg.dec_layers)
    flops = {"backbone": conv_f, "transformer+heads": proj_f + tr_f, "postprocess": 0.0}

    reports = {}
    for B in args.batch:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(0, 1, (B, img_h, img_w, 3)).astype(np.float32)).to(dev)
        fns = {"backbone": stage_backbone, "detr_fwd": stage_fwd, "full": stage_full}
        with torch.no_grad():
            med = {name: median_ms(fn, x, name) for name, fn in fns.items()}
        stage_s = {
            "backbone": med["backbone"],
            "transformer+heads": max(med["detr_fwd"] - med["backbone"], 1e-9),
            "postprocess": max(med["full"] - med["detr_fwd"], 1e-9),
        }
        total = med["full"]
        report = {"full_ms": total * 1e3, "fps": B / total, "stages": {}}
        print(f"\nB={B}  full {total * 1e3:.2f} ms/call "
              f"({B / total:.1f} fps, {1e3 * total / B:.2f} ms/frame)")
        for name, t in stage_s.items():
            fl = flops[name] * B
            tf, mfu = rate(fl, t) if fl else (0.0, None)
            share = 100 * t / total
            report["stages"][name] = {"ms": t * 1e3, "share": share, "tflops": tf, "mfu": mfu}
            print(f"  {name:>18}: {t * 1e3:7.2f} ms  {share:5.1f}%  {tf:6.1f} TF/s  "
                  + (mfu_text(mfu) if fl else "(non-matmul)"))
        _, whole = rate(sum(flops.values()) * B, total)
        report["whole_program_mfu"] = whole
        print(f"  whole-program {mfu_text(whole)}", flush=True)

        if args.per_stage:
            # prefix(0): the stem conv alone (bn/relu/maxpool land in
            # layer1's bucket: elementwise, bound by bytes); prefix(k): the
            # ResNet asked for stage k, which runs no deeper stage
            stage_f = conv_flops_per_stage(img_h, img_w)
            bb = model.backbone
            weight = bb.conv1._compute_params()[0] if args.stem != "conv" else None

            def stem(xx):
                xx = xx.permute(0, 3, 1, 2).to(dtype)
                return bb.conv1(xx) if args.stem == "conv" else resnet.STEMS[args.stem](
                    xx, weight)

            prefixes = {0: stem}
            for k in range(1, 5):
                bb_k = resnet.resnet50(dtype, dcfg.dilation, (k,), args.stem).to(dev).eval()
                bb_k.load_state_dict(bb.state_dict())
                prefixes[k] = (lambda xx, m=bb_k, kk=k: m(xx.permute(0, 3, 1, 2))[kk])
            with torch.no_grad():
                pre = {k: median_ms(fn, x, f"prefix({k})") for k, fn in prefixes.items()}
            print(f"  per-stage backbone attribution (stem={args.stem}; "
                  f"prefix-knockout, medians of {args.passes}):")
            report["prefix_ms"] = {k: t * 1e3 for k, t in pre.items()}
            report["per_stage"] = {}
            prev = 0.0
            for k, name in enumerate(STAGES):
                t = max(pre[k] - prev, 1e-9)
                prev = pre[k]
                tf, mfu = rate(stage_f[name] * B, t)
                share = 100 * t / med["backbone"]
                report["per_stage"][name] = {"ms": t * 1e3, "share": share, "tflops": tf,
                                             "mfu": mfu}
                extra = " (+bn/relu/maxpool)" if name == "layer1" else ""
                print(f"  {name:>18}: {t * 1e3:7.2f} ms  {share:5.1f}% of backbone  "
                      f"{tf:6.1f} TF/s  {mfu_text(mfu)}{extra}")
            print(f"  prefix(4) {pre[4] * 1e3:.2f} ms vs whole backbone "
                  f"{med['backbone'] * 1e3:.2f} ms (consistency check)", flush=True)
        reports[B] = report

    trace = None
    if args.trace_dir:
        with torch.no_grad(), profiler_trace(args.trace_dir):
            stage_full(x)
            synchronize(dev)
        trace = sorted(os.listdir(args.trace_dir))
        print(f"trace written to {args.trace_dir}: {trace}")
    return {"device": banner, "peak_tflops": peak, "batches": reports, "trace": trace}


if __name__ == "__main__":
    main()
