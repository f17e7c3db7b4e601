"""Throughput of batched detection: BatchedDetector at batch 1/4/8/16, with MFU.

    python -m odam_torch.scripts.bench_batched_detection [--dtype bfloat16] [--batches 1,4,8,16]

Counterpart of ``scripts/bench_batched_detection.py``.  The DETR of
``--config_path`` (seeded weights, ``--stem``) detects stacks of B uint8
frames at ``--img_h`` x ``--img_w``:

- device-resident: the stack already on the device, normalized, forward and
  postprocess (one ``BatchedDetector`` batch), ``--iters`` calls closed by a
  synchronize: frames/s, ms a frame, and MFU, the analytic FLOPs of a frame
  (:func:`conv_flops_resnet50` + :func:`transformer_flops`) times frames/s
  over ``--peak_tflops`` (on the card only: a CPU run prints none);
- host-streamed: ``BatchedDetector.detect_frames`` on host frames, copies
  included.

``--peak_tflops`` defaults to the H100's published dense peak for the
dtype: 989 TFLOP/s bf16, and 67 TFLOP/s f32 (the card's f32 rate outside
the tensor cores, since TF32 is off here, as everywhere in the port).  The
first line names the device and, on the card, its power limit, which the
published peak assumes at 700 W.  At batch 1 the attention takes both
kernels; from batch 4 (above ``KERNEL_MAX_BATCH``) the plain path, as in
JAX.  Runs on the card unless ``--device cpu``.

The FLOP counters are JAX's, exactly, and :mod:`.profile_batched_detector`
imports them from here.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device

IMG_H, IMG_W = 800, 1071  # ScanNet 968x1296 -> shorter side 800
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# H100 SXM dense peaks (NVIDIA data sheet), TFLOP/s: bf16 on the tensor
# cores; f32 outside them, since the port runs f32 with TF32 off
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}
RESNET50_LAYERS = ((3, 64), (4, 128), (6, 256), (3, 512))   # (blocks, mid) a stage


def conv_flops_per_stage(h, w):
    """Per-stage forward FLOPs of ResNet-50: {stem, layer1..4} (2*MACs)."""
    stages, _ = _resnet50_flops(h, w)
    return stages


def conv_flops_resnet50(h, w):
    """Forward multiply-add FLOPs (x2) of ResNet-50 at input h x w, and the
    output's (h, w)."""
    stages, hw = _resnet50_flops(h, w)
    return sum(stages.values()), hw


def _resnet50_flops(h, w):
    """({stem, layer1..4}: FLOPs, the final (h, w)).  Every count is an
    integer below 2^53, so sums in any order are exact."""
    stages = {}
    flops = 0.0

    def conv(cin, cout, k, s, hw):
        nonlocal flops
        oh, ow = hw[0] // s, hw[1] // s
        flops += 2.0 * oh * ow * cin * cout * k * k
        return (oh, ow)

    hw = conv(3, 64, 7, 2, (h, w))
    stages["stem"] = flops
    hw = (hw[0] // 2, hw[1] // 2)  # maxpool
    cin = 64
    for stage, (blocks, mid) in enumerate(RESNET50_LAYERS):
        mark = flops
        for b in range(blocks):
            s = 2 if (b == 0 and stage > 0) else 1
            conv(cin, mid, 1, 1, hw)
            hw2 = conv(mid, mid, 3, s, hw)
            conv(mid, mid * 4, 1, 1, hw2)
            if b == 0:
                conv(cin, mid * 4, 1, s, hw)
            hw = hw2
            cin = mid * 4
        stages[f"layer{stage + 1}"] = flops - mark
    return stages, hw


def transformer_flops(tokens, queries, d, ffn, enc, dec):
    """Approximate DETR transformer forward FLOPs."""
    f = 0.0
    # encoder: self-attn (4 proj + 2 matmul) + FFN
    f += enc * (4 * 2 * tokens * d * d + 2 * 2 * tokens * tokens * d
                + 2 * 2 * tokens * d * ffn)
    # decoder: self + cross + FFN
    f += dec * (4 * 2 * queries * d * d + 2 * 2 * queries * queries * d
                + 4 * 2 * (queries + tokens) * d * d
                + 2 * 2 * queries * tokens * d
                + 2 * 2 * queries * d * ffn)
    return f


def transformer_heads_flops(L, Q, d, ffn, enc_layers, dec_layers, heads_out=7):
    """Forward FLOPs (2*MACs) of the DETR transformer + heads: JAX's
    ``profile_batched_detector.transformer_flops``."""
    def attn(lq, lk):
        # qkv/out projections + scores + weighted sum
        return 2 * (3 * lq * d * d + lq * d * d) + 2 * (2 * lq * lk * d)

    def ffn_f(n):
        return 2 * (2 * n * d * ffn)

    enc = enc_layers * (attn(L, L) + ffn_f(L))
    dec = dec_layers * (attn(Q, Q) + attn(Q, L) + ffn_f(Q))
    heads = 2 * Q * d * d * 3 * heads_out  # 6 HeadMLPs approx (3-layer MLP)
    return enc + dec + heads


def _pct(share: float | None) -> str:
    return "not measured (cpu)" if share is None else f"{share:5.1%}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.bench_batched_detection",
                                 description="Batched detection: frames/s and MFU by batch "
                                             "(PyTorch port).")
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--batches", default="1,4,8,16")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--peak_tflops", type=float, default=None,
                    help="the card's peak, TFLOP/s (default: the H100's dense peak for "
                         "--dtype, 989 bf16 / 67 f32)")
    ap.add_argument("--stem", choices=["conv", "s2d", "im2col"], default="conv",
                    help="backbone stem A/B (s2d = space-to-depth rewrite; "
                         "im2col = patch-matrix matmul)")
    ap.add_argument("--img_h", type=int, default=IMG_H)
    ap.add_argument("--img_w", type=int, default=IMG_W)
    ap.add_argument("--config_path", default="configs/detr_scan_net.yaml")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Print one line a batch; return the rows (batch, frames/s, ms a frame,
    MFU, host-streamed frames/s) and the FLOPs a frame."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from .. import config as config_mod
    from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from ..models import detr as detr_mod
    from ..runtime import offline as offline_mod, processor as proc_mod
    from ..utils.metrics import device_banner, synchronize

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    peak = args.peak_tflops or PEAK_TFLOPS[args.dtype]
    banner = device_banner(dev)
    print(f"device: {banner}; dtype {args.dtype}; peak {peak} TFLOP/s", flush=True)
    img_h, img_w = args.img_h, args.img_w

    cfg = config_mod.merge_cfg([args.config_path])
    cfg["stem"] = args.stem
    dcfg = detr_mod.DETRConfig.from_cfg(cfg, dtype=DTYPES[args.dtype], use_kernels=True)
    model = detr_mod.build_detr(dcfg, seed=0, device=dev)
    pcfg = proc_mod.PipelineConfig()

    bb_flops, hw = conv_flops_resnet50(img_h, img_w)
    tokens = hw[0] * hw[1]
    tr_flops = transformer_flops(tokens, dcfg.num_queries, dcfg.hidden_dim,
                                 dcfg.dim_feedforward, dcfg.enc_layers, dcfg.dec_layers)
    per_frame_gflops = (bb_flops + tr_flops) / 1e9
    print(f"model: ~{per_frame_gflops:.0f} GFLOP/frame at {img_h}x{img_w} "
          f"({tokens} tokens)", flush=True)

    K = np.array([[580.0, 0, img_w / 2], [0, 580.0, img_h / 2], [0, 0, 1]], np.float32)
    K_dev = torch.from_numpy(K).to(dev)
    mean, std = (torch.from_numpy(x).to(dev) for x in (IMAGENET_MEAN, IMAGENET_STD))
    rng = np.random.default_rng(0)
    rows = []
    for B in [int(b) for b in args.batches.split(",")]:
        det = offline_mod.BatchedDetector(model, pcfg, batch_size=B, device=dev)
        frames = [rng.integers(0, 255, (img_h, img_w, 3), np.uint8) for _ in range(B)]
        stack_dev = torch.from_numpy(np.stack(frames)).to(dev)

        def run():   # one BatchedDetector batch on device-resident frames
            images = proc_mod.device_images(stack_dev, dev, mean, std, dcfg.dtype)
            return proc_mod.detect_frame(pcfg, model, images, K_dev, float(img_w),
                                         float(img_h))

        with torch.no_grad():
            run()
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                run()
            synchronize(dev)
        dt = (time.perf_counter() - t0) / args.iters
        fps = B / dt
        # a utilization of the card's peak: not a number a CPU run can give
        mfu = fps * per_frame_gflops / 1e3 / peak if dev.type == "cuda" else None

        n_e2e = max(args.iters // 2, 2)
        det.detect_frames(frames, K, img_w, img_h)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n_e2e):
            det.detect_frames(frames, K, img_w, img_h)
        synchronize(dev)
        fps_e2e = B * n_e2e / (time.perf_counter() - t0)

        rows.append({"batch": B, "fps": fps, "ms_per_frame": dt / B * 1e3, "mfu": mfu,
                     "host_streamed_fps": fps_e2e})
        print(f"batch {B:3d}: device {fps:7.1f} frames/s "
              f"({dt / B * 1e3:6.2f} ms/frame, MFU {_pct(mfu)}) | "
              f"host-streamed {fps_e2e:6.1f} frames/s", flush=True)
    best = max(rows, key=lambda r: r["fps"])
    print(f"best device-resident: batch {best['batch']} at {best['fps']:.1f} frames/s "
          f"(MFU {_pct(best['mfu'])})")
    return {"device": banner, "peak_tflops": peak, "gflop_per_frame": per_frame_gflops,
            "rows": rows}


if __name__ == "__main__":
    main()
