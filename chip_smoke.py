#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card (an H100 for this repo).

    python3 chip_smoke.py              # the whole check; exits 0 only if all holds
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown of two steps

Phases, each printed as one JSON line on stdout:

1. toolchain: torch, CUDA, nvcc and Triton versions, the card's name and
   power limit;
2. build: nvcc builds the attention kernels and the LAP kernel from
   odam_torch/csrc, one nvcc a source, started together; ptxas' registers
   and spills, and the HMMA (tensor-core) instructions of each attention
   kernel in cuobjdump's SASS (it fails if a kernel has none);
3. kernels: each kernel at every main-path shape (f32 and bf16) and at
   edge cases, held to its plain PyTorch version on the same inputs (f32
   with TF32 off; bf16 within 4 roundings of the case's largest output),
   with kernel, plain and library (SDPA, a
   yardstick only) times: device time per call from a CUDA graph of 20
   calls, replayed, and the back-to-back issue time of the same calls; the
   offline detector's batch-8 shapes too, which the routing sends to the
   plain path (so their times show what that routing costs);
   lap: the LAP kernel (odam_torch/csrc/lap.cu) against its plain version,
   the host solver, at the decode's shapes (B = 1 and 8), the matcher's 48
   problems, tie-heavy integer costs, all-masked problems and 256 x 256:
   assignments equal in every problem, total cost equal to scipy's, device
   time from a CUDA graph beside the host path's (copy + host solve);
4. modules: the full-width DETR on one 800x1071 frame and the full-width
   associator on a filled 64x100 store, on the card (kernels) against the
   same module and weights on the CPU (plain versions);
   detr_variants: the same DETR with pre-norm, the learned-encoding option,
   the dilated last stage and the s2d stem, card against CPU, both
   attention kernels launched; im2col and s2d held to the conv stem on the
   card;
5. slice: OdamPipeline at full width with seeded weights over 8 YUV 4:2:0
   frames, with the kernel launch counts of every frame checked (one LAP
   launch a frame once associated) and no host sync and no synchronizing
   CUDA call once the store holds a track (frame 2 on);
6. slice_bf16: the same with the same weights in bf16: the bf16
   instantiations of both kernels with the f32 launch counts, every
   frame's detection rows against the f32 slice's within 2% (BF16_ROW_RTOL)
   and its track ids equal to the f32 slice's;
7. offline: the same 8 frames through BatchedDetector (batch 8) and the
   cached-detection pipeline: the online slice's track ids, rows within
   1e-3, launches flash 0, fused 16 and one LAP a frame once tracks exist,
   no host sync from frame 2 (synchronizing CUDA calls reported);
8. scene_parallel_full: SceneParallelRunner at full width, P = 1, 2, 4
   and 8 lanes of 8 uint8 frames each (every lane in its own order), f32
   then bf16, every lane against the serial f32 pipeline; aggregate
   frames/s, step and lane-frame times, launches a step (profiled), host
   syncs (none from step 2 on), one LAP launch a step, peak memory, and
   both kernels' launches at B = P;
9. mapping: optim_process -> merge_process -> optim_process at the default
   PipelineConfig (64 objects x 256 views x 1000 samples x 200 iterations)
   on a synthetic scene of 64 ground-truth boxes and 256 cameras at
   800x1071: the loss falls more than 10x, the mean IoU with the ground
   truth is above 0.7, the first 5 iterations agree with the CPU within
   rtol 1e-4; the time of each stage and a profile of the solve's
   iterations;
10. mapping_lm: the same with ``optim_solver="lm"`` (40 LM iterations, the
    Adam fallback): the loss falls, mean IoU above 0.7, at most 16 objects
    fall back, the first 3 iterations agree with the CPU within rtol 1e-3;
11. scene: ``python -m odam_torch.scripts.run_processor --dtype float32``
    then ``eval_scan2cad`` on the three committed hard-split scenes with
    the committed weights (artifacts/torch/*.npz), on the card and on the
    CPU: the same tracks, boxes and F1 table, and the kernel launches of
    every frame checked;
12. scene_parallel_hard: SceneParallelRunner on the same three scenes at
    P = 3 and 4 (one lane of padding) against the serial OdamPipeline on
    the card: tracks with frame ids and classes exact, rows within 1e-3,
    the scene phase's F1 table, fused_attention launched at B = P;
    cli_scene_parallel: ``run_processor --scene_parallel 3`` and
    ``eval_scan2cad`` give the scene phase's F1 table;
13. cli_full, cli_fast, cli_offline: ``run_processor`` at full width
    (configs/detr_scan_net.yaml, seeded weights) on 4 frames of one
    committed scene resized to 800x800: f32 online; ``--profile fast
    --device_resize`` in bf16; ``--offline --detect_batch 4 --solver lm``
    in bf16; the kernel launches of every frame checked, with their dtype;
14. train_detector: the detector's train step at full width on the plain
    attention path: one f32 step card against CPU (loss within 1e-4, each
    leaf's gradient within 1e-3), then 10 bf16 steps at batch 8, 512x672
    on one synthetic batch: step time, images/s, peak memory, the loss
    falling, one LAP launch a step and no synchronizing call in the
    matcher, frozen leaves bit-equal, no attention kernel launched, and a
    profile of two steps (host- or device-bound);
15. train_assoc: the same for the associator at its defaults (20 steps,
    batch 8, no host sync);
16. train_cli: ``python -m odam_torch.scripts.train_{detector,associator}
    --synthetic --steps 3`` on the card, their checkpoints through
    ``run_processor.build_models`` and a 2-frame ``run_processor`` run;
17. dist_nccl, dist_gloo2: ``odam_torch.scripts.dryrun_distributed``'s six
    stages at full width on 1 NCCL rank and on 2 gloo ranks sharing the
    card, each rank held to the same stages in one process, with step
    times, the gradient all-reduce, peak memory, launches by stage and the
    lanes' aggregate frames/s at P = 8 (1 x 8 here, 2 x 4 over the ranks);
18. cli_dist: ``run_processor --scene_parallel 4`` and ``train_detector``
    on 2 gloo ranks under ``python -m torch.distributed.run``: the scene
    phase's F1 table, and the checkpoint read by ``run_processor``;
19. tracking: ``python -m odam_torch.scripts.run_tracking`` (detector and
    heuristic tracker) at full width with seeded weights in bf16 on the
    hard split at 800x800: per scene frames/s, the median frame, host
    copies a frame, launches by kernel and dtype (flash 12, fused 6 a
    frame); tracking_rehearsal: ``run_tracking.track_scene`` with the
    committed rehearsal detector in f32 on 8 frames at 800x800 (2500 image
    tokens), card against CPU within the DETR bar;
20. eval_association: the CLI with the full-width associator (seeded
    weights, .npz) on 2 synthetic scenes x 6 tracks x 40 frames (ms a
    frame, fused 16 launches a frame), then with the committed rehearsal
    associator, P / R / F1 card = CPU;
21. mapping_tools: ``run_multi_view`` (200 iterations) and ``run_merge`` on
    tracking_rehearsal's tracks; 5 iterations card against CPU (bboxes_dl
    within 1e-3, bboxes_qc IoU >= 0.95, merged tracks equal).

Then the kernel table (the LAP kernel's rows too) with the launch counts of
every path, the card's name and power limit as nvidia-smi prints them,
and as the last line {"ok": true, "device": {...}}.  It imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense).
# The kernels run f32 as 3xTF32 on the tensor cores: three TF32 products for
# each f32 one, so their f32 bound is 3 x FLOP over the 495 TFLOP/s TF32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
BOUND_RATE = {torch.float32: "3 x FLOP over 495 TFLOP/s TF32 (3xTF32), or bytes over 3.35 TB/s",
              torch.bfloat16: "FLOP over 989 TFLOP/s bf16, or bytes over 3.35 TB/s"}
GRAPH_CALLS = 20                  # calls captured in one CUDA graph for device times

F32_ATOL = {"fused_attention": 2e-5, "flash_attention": 3e-5}   # the CPU tests' bars
# bf16 keeps 8 significant bits, so a rounding moves a value by up to 2^-8 of
# itself.  The kernels round P and the output to bf16, the plain version only
# the output.  With randn q/k/v over hundreds of keys the softmax is diffuse
# and a typical output is 0.03-0.06, so the bar scales with the case's output:
# BF16_ROUNDINGS such steps of its largest plain value.
BF16_ROUNDINGS = 4
# an all-masked row against the uniform average (bf16: the same scaled bar)
ALL_MASKED_F32_ATOL = 1e-4
DETR_ATOL = DETR_RTOL = 1e-3      # f32 card vs CPU, sums in another order
ASSOC_ATOL = 5e-4                 # log_assignment, the CPU tests' bar
ASSOC_MATCH_THRESHOLD = 0.01

TPU_KERNEL = {"fused_attention": "odam_tpu/ops/pallas_attention.py:76",
              "flash_attention": "odam_tpu/ops/pallas_attention.py:177"}
SOURCE = "odam_torch/csrc/attention.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed, so the host's issue rate is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def toolchain() -> dict:
    from odam_torch.ops.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    return {"phase": "toolchain", "python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc, "triton": triton_version,
            "nvidia_smi": smi_line(), "device": torch.cuda.get_device_name(0)}


def cuobjdump_path() -> str:
    from odam_torch.ops.build import nvcc_path

    cands = [os.path.join(os.path.dirname(nvcc_path()), "cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    except ImportError:
        pass
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found: the toolkit's or Triton's is needed for the SASS")


def hmma_counts(library: str) -> dict:
    """HMMA instructions per kernel instantiation in the library's SASS."""
    sass = subprocess.run([cuobjdump_path(), "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            sym = re.search(r"(flash|fused)_attn_kernelI(f|13__nv_bfloat16)Li(\d+)E", m.group(1))
            current = (f"{sym.group(1)}_attn_kernel<{'float' if sym.group(2) == 'f' else 'bf16'}, "
                       f"{sym.group(3)}>") if sym else m.group(1)
            counts[current] = 0
        elif current is not None and "HMMA" in line:
            counts[current] += 1
    return counts


def build() -> dict:
    """Both kernel libraries from odam_torch/csrc, one nvcc each, started
    together; ptxas' registers and spills, and the HMMA instructions of
    each attention kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from odam_torch.ops import cuda_attention, lap

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(m.load_library) for m in (cuda_attention, lap)]:
            job.result()
    seconds = time.perf_counter() - t0
    libs = {}
    for name, info in (("attention", cuda_attention.BUILD_INFO), ("lap", lap.BUILD_INFO)):
        libs[name] = {"seconds": info["seconds"] if not info["cached"] else "cached",
                      "library": os.path.relpath(info["path"]),
                      "ptxas": [ln.strip() for ln in info.get("ptxas", "").splitlines()
                                if "registers" in ln or "spill" in ln or "smem" in ln]}
    hmma = hmma_counts(cuda_attention.BUILD_INFO["path"])
    for kernel in ("flash_attn_kernel", "fused_attn_kernel"):
        found = {sym: n for sym, n in hmma.items() if kernel in sym}
        if not found or min(found.values()) == 0:
            raise AssertionError(f"{kernel}: no HMMA instruction in its SASS ({found})")
    return {"phase": "build", "seconds": seconds, "libraries": libs, "hmma": hmma}


# ------------------------------------------------------------------ kernels

def _case(name, B, Lq, Lk, H, dh, dtype, masked_tail=0, all_masked_row=False, mask=True,
          label="", path=None):
    return dict(name=name, B=B, Lq=Lq, Lk=Lk, H=H, dh=dh, dtype=dtype,
                masked_tail=masked_tail, all_masked_row=all_masked_row, mask=mask, label=label,
                path=path)


SP_LANES = (1, 2, 4, 8)            # the lanes of scene_parallel_full


def _lane_cases() -> list[dict]:
    """Every attention call of the lane step at full width, at B = P: the
    lanes stacked on the batch axis, one launch for all of them."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for P in SP_LANES[1:]:
            tag = f"lanes P={P}: "
            cases += [
                _case("flash_attention", P, 850, 850, 8, 32, dtype,
                      label=tag + "DETR encoder self", path="lanes"),
                _case("flash_attention", P, 100, 850, 8, 32, dtype,
                      label=tag + "DETR decoder cross", path="lanes"),
                _case("fused_attention", P, 100, 100, 8, 32, dtype, mask=False,
                      label=tag + "DETR decoder self", path="lanes"),
                _case("fused_attention", P, 64, 64, 4, 64, dtype, masked_tail=20,
                      label=tag + "GNN track self", path="lanes"),
                _case("fused_attention", P, 30, 30, 4, 64, dtype, mask=False,
                      label=tag + "GNN detection self", path="lanes"),
                _case("fused_attention", P, 64, 30, 4, 64, dtype, mask=False,
                      label=tag + "GNN track<-detection cross", path="lanes"),
                _case("fused_attention", P, 30, 64, 4, 64, dtype, masked_tail=20,
                      label=tag + "GNN detection<-track cross", path="lanes"),
            ]
    return cases


KERNEL_CASES = [
    # main-path shapes (B = 1, 800x1071 frame, full width)
    _case("flash_attention", 1, 850, 850, 8, 32, torch.float32, label="DETR encoder self"),
    _case("flash_attention", 1, 100, 850, 8, 32, torch.float32, label="DETR decoder cross"),
    _case("fused_attention", 1, 100, 100, 8, 32, torch.float32, mask=False,
          label="DETR decoder self"),
    _case("fused_attention", 1, 64, 64, 4, 64, torch.float32, masked_tail=20,
          label="GNN track self"),
    _case("fused_attention", 1, 30, 30, 4, 64, torch.float32, mask=False,
          label="GNN detection self"),
    _case("fused_attention", 1, 64, 30, 4, 64, torch.float32, mask=False,
          label="GNN track<-detection cross"),
    _case("fused_attention", 1, 30, 64, 4, 64, torch.float32, masked_tail=20,
          label="GNN detection<-track cross"),
    # the scene path: the committed rehearsal model (hidden 64 over 4 heads,
    # 16 queries) on 192x192 frames (144 image tokens, below FLASH_MIN_KEYS),
    # and its GNN over 64 track slots (5 to 21 of them live) and 30
    # detection slots
    _case("fused_attention", 1, 144, 144, 4, 16, torch.float32, label="scene: encoder self"),
    _case("fused_attention", 1, 16, 144, 4, 16, torch.float32, label="scene: decoder cross"),
    _case("fused_attention", 1, 16, 16, 4, 16, torch.float32, mask=False,
          label="scene: decoder self"),
    _case("fused_attention", 1, 64, 64, 4, 16, torch.float32, masked_tail=45,
          label="scene: GNN track self"),
    _case("fused_attention", 1, 30, 30, 4, 16, torch.float32, mask=False,
          label="scene: GNN detection self"),
    _case("fused_attention", 1, 64, 30, 4, 16, torch.float32, mask=False,
          label="scene: GNN track<-detection cross"),
    _case("fused_attention", 1, 30, 64, 4, 16, torch.float32, masked_tail=59,
          label="scene: GNN detection<-track cross"),
    # tracking_rehearsal: the committed rehearsal detector on its 192x192
    # frames resized to 800x800 by target_size (2500 image tokens, dh 16)
    _case("flash_attention", 1, 2500, 2500, 4, 16, torch.float32,
          label="tracking_rehearsal: encoder self"),
    _case("flash_attention", 1, 16, 2500, 4, 16, torch.float32,
          label="tracking_rehearsal: decoder cross"),
    _case("flash_attention", 1, 2500, 2500, 4, 16, torch.bfloat16,
          label="tracking_rehearsal: encoder self"),
    _case("flash_attention", 1, 16, 2500, 4, 16, torch.bfloat16,
          label="tracking_rehearsal: decoder cross"),
    _case("fused_attention", 1, 16, 16, 4, 16, torch.bfloat16, mask=False,
          label="tracking_rehearsal: decoder self"),
    # the full-width CLI run: 192x192 frames resized to 800x800 (625 tokens)
    _case("flash_attention", 1, 625, 625, 8, 32, torch.float32, label="cli_full: encoder self"),
    _case("flash_attention", 1, 100, 625, 8, 32, torch.float32,
          label="cli_full: decoder cross"),
    # edge cases
    _case("flash_attention", 2, 37, 300, 2, 16, torch.float32, masked_tail=7,
          label="ragged Lk, masked tail, B=2, dh=16"),
    _case("flash_attention", 2, 100, 850, 8, 32, torch.float32, masked_tail=3,
          all_masked_row=True, label="all-masked batch row"),
    _case("flash_attention", 1, 64, 400, 4, 64, torch.float32, masked_tail=50,
          label="long track window, dh=64"),
    _case("fused_attention", 2, 100, 100, 4, 64, torch.float32, masked_tail=5,
          all_masked_row=True, label="all-masked batch row"),
    _case("fused_attention", 2, 144, 144, 4, 16, torch.float32, masked_tail=9,
          label="committed-model tokens, dh=16, B=2"),
    _case("fused_attention", 1, 65, 255, 2, 32, torch.float32, masked_tail=1,
          label="largest fused Lk"),
    # edge cases of the split-key design: Lq not a multiple of 16, warps of
    # a block with no tile, masked tails that cover whole warps' shares
    _case("flash_attention", 1, 1, 850, 8, 32, torch.float32, masked_tail=3, label="Lq 1"),
    _case("fused_attention", 1, 1, 100, 4, 64, torch.float32, masked_tail=3, label="Lq 1"),
    _case("fused_attention", 2, 37, 77, 2, 32, torch.float32, masked_tail=5, label="Lq 37"),
    _case("flash_attention", 1, 37, 1, 2, 32, torch.float32, mask=False,
          label="Lk 1: seven warps without a tile"),
    _case("flash_attention", 1, 37, 64, 2, 32, torch.float32,
          label="Lk 64: four warps without a tile"),
    _case("flash_attention", 2, 37, 65, 2, 64, torch.float32, masked_tail=1,
          label="Lk 65: a tile of one padded key"),
    _case("flash_attention", 1, 50, 257, 4, 32, torch.float32, masked_tail=2,
          label="Lk 257: a ragged tile of one key"),
    _case("flash_attention", 1, 50, 128, 4, 32, torch.float32, masked_tail=40,
          label="masked tail covers warps 6 and 7"),
    _case("fused_attention", 1, 50, 100, 4, 32, torch.float32, masked_tail=40,
          label="masked tail covers warps 4 to 6"),
    # bf16: every main-path shape of the bf16 step (slice_bf16, cli_fast)
    _case("flash_attention", 1, 850, 850, 8, 32, torch.bfloat16, label="DETR encoder self"),
    _case("flash_attention", 1, 100, 850, 8, 32, torch.bfloat16, label="DETR decoder cross"),
    _case("fused_attention", 1, 100, 100, 8, 32, torch.bfloat16, mask=False,
          label="DETR decoder self"),
    _case("fused_attention", 1, 64, 64, 4, 64, torch.bfloat16, masked_tail=20,
          label="GNN track self"),
    _case("fused_attention", 1, 30, 30, 4, 64, torch.bfloat16, mask=False,
          label="GNN detection self"),
    _case("fused_attention", 1, 64, 30, 4, 64, torch.bfloat16, mask=False,
          label="GNN track<-detection cross"),
    _case("fused_attention", 1, 30, 64, 4, 64, torch.bfloat16, masked_tail=20,
          label="GNN detection<-track cross"),
    _case("flash_attention", 1, 625, 625, 8, 32, torch.bfloat16, label="cli_fast: encoder self"),
    _case("flash_attention", 1, 100, 625, 8, 32, torch.bfloat16,
          label="cli_fast: decoder cross"),
    # the offline detector's batch of 8 frames: above KERNEL_MAX_BATCH, so
    # the port (as JAX) routes these calls to the plain path; timed here to
    # show what that routing costs on the card
    _case("flash_attention", 8, 850, 850, 8, 32, torch.float32, label="offline B=8: encoder self"),
    _case("fused_attention", 8, 100, 100, 8, 32, torch.float32, mask=False,
          label="offline B=8: decoder self"),
    _case("flash_attention", 8, 850, 850, 8, 32, torch.bfloat16,
          label="offline B=8: encoder self"),
    _case("fused_attention", 8, 100, 100, 8, 32, torch.bfloat16, mask=False,
          label="offline B=8: decoder self"),
    _case("fused_attention", 1, 65, 255, 4, 64, torch.bfloat16, masked_tail=1,
          label="largest fused Lk, dh=64"),
    _case("flash_attention", 2, 37, 257, 2, 16, torch.bfloat16, masked_tail=7,
          all_masked_row=True, label="ragged Lk, all-masked batch row, dh=16"),
    # scene_parallel_full: the lane step at P = 2, 4, 8 (P = 1 is the slice's)
    *_lane_cases(),
]


def kernel_checks(gen: torch.Generator) -> list[dict]:
    from odam_torch.ops import cuda_attention as ca

    rows = []
    for c in KERNEL_CASES:
        B, Lq, Lk, H, dh, dtype = c["B"], c["Lq"], c["Lk"], c["H"], c["dh"], c["dtype"]
        q = torch.randn(B, Lq, H, dh, generator=gen).to("cuda", dtype)
        k = torch.randn(B, Lk, H, dh, generator=gen).to("cuda", dtype)
        v = torch.randn(B, Lk, H, dh, generator=gen).to("cuda", dtype)
        kpm = None
        if c["mask"]:
            kpm = torch.zeros(B, Lk, dtype=torch.bool)
            if c["masked_tail"]:
                kpm[:, -c["masked_tail"]:] = True
            if c["all_masked_row"]:
                kpm[-1] = True
            kpm = kpm.cuda()
        wrapper = getattr(ca, c["name"])
        out = wrapper(q, k, v, kpm)
        ref = ca.attention_plain(q, k, v, kpm)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        max_err = float(err.max())
        if dtype == torch.float32:
            tol = F32_ATOL[c["name"]]
            tol_desc = {"atol": tol}
        else:
            tol = BF16_ROUNDINGS * 2.0 ** -8 * float(ref.float().abs().max())
            tol_desc = {"atol": tol, "rule": f"{BF16_ROUNDINGS} x 2^-8 x max|plain|"}
        ok = max_err <= tol
        if c["all_masked_row"]:      # uniform average over the Lk keys
            uniform = v[-1].float().mean(dim=0, keepdim=True).expand(Lq, H, dh)
            masked_tol = (ALL_MASKED_F32_ATOL if dtype == torch.float32
                          else BF16_ROUNDINGS * 2.0 ** -8 * float(uniform.abs().max()))
            ok = ok and float((out[-1].float() - uniform).abs().max()) <= masked_tol
        if not ok:
            raise AssertionError(f"{c['name']} {c['label']}: max|kernel-plain| {max_err:.3e} "
                                 f"exceeds {tol_desc}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        attn_mask = None if kpm is None else ~kpm[:, None, None, :]
        calls = {"": lambda: wrapper(q, k, v, kpm),
                 "plain_": lambda: ca.attention_plain(q, k, v, kpm),
                 "library_": lambda: torch.nn.functional.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=attn_mask)}
        times = {}
        for key, fn in calls.items():
            times[f"{key}issue_ms"] = cuda_ms(fn)
            times[f"{key}device_ms"] = graph_ms(fn)
        esize = torch.finfo(dtype).bits // 8
        n_bytes = esize * (2 * B * Lq * H * dh + 2 * B * Lk * H * dh) + (0 if kpm is None
                                                                           else B * Lk)
        flops = 4.0 * B * H * Lq * Lk * dh
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        rows.append({
            "name": c["name"], "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNEL[c["name"]], "case": c["label"],
            "shape": {"B": B, "Lq": Lq, "Lk": Lk, "H": H, "dh": dh,
                      "masked_tail": c["masked_tail"], "all_masked_row": c["all_masked_row"]},
            "dtype": str(dtype).replace("torch.", ""), "path": c["path"], "launches": None,
            "max_abs_err": max_err, "tol": tol_desc, "ms": times["device_ms"],
            "plain_ms": times["plain_device_ms"], "library_ms": times["library_device_ms"],
            **times,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_rate": BOUND_RATE[dtype],
            "gflop": flops / 1e9, "mbytes": n_bytes / 1e6,
        })
    return rows


# ---------------------------------------------------------------------- lap

LAP_SOURCE = "odam_torch/csrc/lap.cu"
# not a Pallas kernel: JAX's exact solver is plain XLA while-loops
LAP_REPLACES = "odam_tpu/ops/lap.py:32"
LAP_SEED = 9
VARIANTS_SEED = 13


def _solve_input(fn, *args) -> torch.Tensor:
    """The cost [S, R, C] that ``fn(*args)`` (run on the CPU) hands to
    ``lap.solve``: the priced, transposed problems of a decode or a match."""
    from odam_torch.ops import lap

    seen, real = [], lap.solve
    lap.solve = lambda cost: seen.append(cost) or real(cost)
    try:
        fn(*args)
    finally:
        lap.solve = real
    return seen[0].reshape(-1, *seen[0].shape[-2:]).contiguous()


def _lap_cases(rng) -> list[tuple[str, torch.Tensor]]:
    """The solver's inputs on the main paths and at the edges."""
    from odam_torch.ops import lap

    def decode(B, n_tracks=48, n_dets=26, T=64, N=30):
        score = torch.from_numpy(rng.random((B, T, N)).astype(np.float32))
        rm, cm = torch.zeros(B, T, dtype=torch.bool), torch.zeros(B, N, dtype=torch.bool)
        rm[:, :n_tracks], cm[:, :n_dets] = True, True
        return _solve_input(lap.match_by_score, score, ASSOC_MATCH_THRESHOLD, rm, cm)

    S, B, Q, M = 6, 8, 100, 8           # train_detector: 6 decoder layers x batch 8
    cost = torch.from_numpy((rng.normal(size=(S, B, Q, M)) * 3).astype(np.float32))
    tmask = torch.from_numpy(rng.random((B, M)) < 0.6)
    match = _solve_input(lap.masked_assignment, cost, torch.ones(S, B, Q, dtype=torch.bool),
                         tmask.expand(S, B, M))
    return [
        ("decode B=1 (48 tracks x 26 detections of 64 x 30)", decode(1)),
        ("decode B=8 (lanes P=8)", decode(8)),
        ("matcher (6 layers x 8 images, 100 queries x 8 targets)", match),
        ("tie-heavy integer costs 0..3", torch.from_numpy(
            rng.integers(0, 4, size=(16, 30, 64)).astype(np.float32))),
        ("all-masked decode", decode(4, n_tracks=0, n_dets=0)),
        ("256 x 256", torch.from_numpy(rng.normal(size=(1, 256, 256)).astype(np.float32))),
    ]


def lap_checks() -> tuple[dict, list[dict]]:
    """The LAP kernel against its plain version (the host solver) on the
    same inputs: assignments equal in every problem, total cost equal to
    scipy's; the kernel's device time from a CUDA graph, beside the host
    path's (the copy to the host and the plain solve) as its yardstick; and
    the decode and the matcher whole on the card against the CPU."""
    from scipy.optimize import linear_sum_assignment

    from odam_torch.ops import lap

    rng = np.random.default_rng(LAP_SEED)
    rows = []
    for label, cost in _lap_cases(rng):
        S, R, C = cost.shape
        gpu = cost.cuda()
        got = lap.solve(gpu)
        torch.cuda.synchronize()
        want = lap.solve(cost)
        if not torch.equal(got.cpu(), want):
            bad = int((got.cpu() != want).any(-1).sum())
            raise AssertionError(f"lap_solve {label}: {bad} of {S} problems differ from the "
                                 "plain solver")
        c = cost.numpy()
        ours = np.take_along_axis(c, want.long().numpy()[..., None], -1)[..., 0].sum(-1)
        best = np.array([c[s][linear_sum_assignment(c[s])].sum() for s in range(S)])
        gap = float(np.abs(ours - best).max())
        if not gap <= 1e-5 * max(1.0, float(np.abs(best).max())):
            raise AssertionError(f"lap_solve {label}: total cost {gap:.3e} from scipy's")

        def host_path():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lap.solve(gpu.cpu())
            return (time.perf_counter() - t0) * 1e3

        host_ms = sorted(host_path() for _ in range(5))[2]
        n_bytes = 4 * S * R * C + 4 * S * R
        rows.append({
            "name": "lap_solve", "route": "cuda", "source": LAP_SOURCE,
            "replaces": LAP_REPLACES, "case": label, "shape": {"S": S, "R": R, "C": C},
            "dtype": "float32", "path": "lap", "launches": None,
            "max_abs_err": 0.0, "tol": "assignments equal to the plain solver's; total cost "
                                       "within 1e-5 x max(1, |cost|) of scipy's",
            "total_cost_gap_scipy": gap,
            "ms": graph_ms(lambda: lap.solve(gpu)), "issue_ms": cuda_ms(lambda: lap.solve(gpu)),
            "plain_ms": host_ms, "plain_is": "copy to the host + the plain solver (median of 5)",
            "library_ms": None,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_note": "bytes over 3.35 TB/s; the kernel is latency-bound (a chain of "
                          "dependent warp reductions per Dijkstra step)",
            "mbytes": n_bytes / 1e6,
        })
    # the whole decode (pricing, solve, scatter) and the matcher on the card
    B, T, N = 8, 64, 30
    score = torch.from_numpy(rng.random((B, T, N)).astype(np.float32))
    rm = torch.from_numpy(rng.random((B, T)) < 0.75)
    cm = torch.from_numpy(rng.random((B, N)) < 0.85)
    dec = lap.match_by_score(score.cuda(), ASSOC_MATCH_THRESHOLD, rm.cuda(), cm.cuda())
    if not torch.equal(dec.cpu(), lap.match_by_score(score, ASSOC_MATCH_THRESHOLD, rm, cm)):
        raise AssertionError("match_by_score: the card's decode differs from the CPU's")
    cost = rng.normal(size=(3, 40, 25)).astype(np.float32)       # R > C: the transpose
    r_card, c_card = lap.linear_sum_assignment(torch.from_numpy(cost).cuda())
    for s, (r, c) in enumerate(zip(r_card.cpu().numpy(), c_card.cpu().numpy())):
        r_ref, c_ref = linear_sum_assignment(cost[s])
        if not (np.array_equal(r, r_ref) and np.isclose(cost[s][r, c].sum(),
                                                         cost[s][r_ref, c_ref].sum())):
            raise AssertionError(f"linear_sum_assignment problem {s}: rows or total cost "
                                 "differ from scipy's")
    report = {"phase": "lap", "cases": len(rows), "all_equal_plain": True,
              "decode_card_equals_cpu": True, "linear_sum_assignment_equals_scipy": True,
              "device_ms": {r["case"]: r["ms"] for r in rows},
              "host_path_ms": {r["case"]: r["plain_ms"] for r in rows}}
    return report, rows


# ------------------------------------------------------------------ modules

def _intrinsics(img_h: int, img_w: int) -> np.ndarray:
    """ScanNet's 968x1296 color intrinsics scaled to the frame, as bench.py has them."""
    return np.array([[1170.0 * img_w / 1296, 0, img_w / 2],
                    [0, 1170.0 * img_h / 968, img_h / 2], [0, 0, 1]], np.float32)


def _pose(f: int) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    phi = 0.02 * f
    T[:3, :3] = [[np.cos(phi), -np.sin(phi), 0], [np.sin(phi), np.cos(phi), 0], [0, 0, 1]]
    T[:3, 3] = [0.05 * f, 0, 1.4]
    return T


def module_checks(rng) -> tuple[dict, object, object]:
    from odam_torch.models import associator, detr
    from odam_torch.ops import cuda_attention as ca

    det_gpu = detr.build_detr(detr.DETRConfig(), seed=0)
    det_cpu = detr.build_detr(detr.DETRConfig(), seed=0, device="cpu")
    img = rng.normal(size=(1, 800, 1071, 3)).astype(np.float32)
    img_gpu = torch.from_numpy(img).cuda()
    with torch.no_grad():
        _reset_counts()
        out_gpu = det_gpu(img_gpu)
        torch.cuda.synchronize()
        detr_launches = _launches()
        detr_ms = cuda_ms(lambda: det_gpu(img_gpu), reps=10, warmup=2)
        out_cpu = det_cpu(torch.from_numpy(img))
    detr_err = {}
    for name in ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size",
                 "pred_depth", "pred_obj_features"):
        g, c = out_gpu[name].cpu(), out_cpu[name]
        if not torch.isfinite(g).all():
            raise AssertionError(f"DETR {name} not finite on the card")
        if not torch.allclose(g, c, atol=DETR_ATOL, rtol=DETR_RTOL):
            raise AssertionError(f"DETR {name}: card vs CPU max|diff| "
                                 f"{float((g - c).abs().max()):.3e}")
        detr_err[name] = float((g - c).abs().max())
    if detr_launches != {"flash_attention": 12, "fused_attention": 6, "lap_solve": 0}:
        raise AssertionError(f"DETR forward launches {detr_launches}")

    as_gpu = associator.build_associator(associator.AssociatorConfig(), seed=1)
    as_cpu = associator.build_associator(associator.AssociatorConfig(), seed=1, device="cpu")
    T, W, N = 64, 100, 30
    tracks = (rng.normal(size=(1, T, W, 79)) * 0.5).astype(np.float32)
    tracks[..., 0] = np.arange(W)
    dets = np.full((1, N, 79), -1.0, np.float32)
    dets[0, :, 1:] = tracks[0, :N, -1, 1:] + rng.normal(size=(N, 78)).astype(np.float32) * 0.05
    dets[0, :, 0] = W
    tm = np.ones((1, T), bool)
    tm[0, 48:] = False                 # 48 live tracks, 16 padded slots
    dm = np.ones((1, N), bool)
    dm[0, 26:] = False                 # 26 detections, 4 padded rows
    # Seeded weights spread the Sinkhorn mass (every probability here is
    # below 0.04), so at the pipeline's 0.1 no detection would match; at
    # 0.01 the exact-match check covers all 26 detections.
    args = [torch.from_numpy(a) for a in (tracks, tm, dets, dm)] + [ASSOC_MATCH_THRESHOLD]
    args_gpu = [a.cuda() for a in args[:4]] + [ASSOC_MATCH_THRESHOLD]
    with torch.no_grad():
        _reset_counts()
        o_gpu = as_gpu(*args_gpu)
        torch.cuda.synchronize()
        assoc_launches = _launches()
        assoc_ms = cuda_ms(lambda: as_gpu(*args_gpu), reps=5, warmup=1)
        o_cpu = as_cpu(*args)
    Zg, Zc = o_gpu.log_assignment.cpu(), o_cpu.log_assignment
    live = Zc > -1e8
    z_err = float((Zg[live] - Zc[live]).abs().max())
    if not torch.isfinite(Zg[live]).all() or z_err > ASSOC_ATOL:
        raise AssertionError(f"associator log_assignment card vs CPU {z_err:.3e}")
    n_matched = int((o_cpu.matches >= 0).sum())
    if not torch.equal(o_gpu.matches.cpu(), o_cpu.matches) or n_matched == 0:
        raise AssertionError(f"associator matches differ between card and CPU "
                             f"({n_matched} matched on the CPU)")
    if assoc_launches != {"flash_attention": 0, "fused_attention": 16, "lap_solve": 1}:
        raise AssertionError(f"associator launches {assoc_launches}")
    report = {"phase": "modules",
              "detr": {"max_abs_err": detr_err, "tol": {"atol": DETR_ATOL, "rtol": DETR_RTOL},
                       "launches": detr_launches, "forward_ms": detr_ms},
              "associator": {"log_assignment_max_abs_err": z_err, "tol": {"atol": ASSOC_ATOL},
                             "matches_equal": True,
                             "match_threshold": ASSOC_MATCH_THRESHOLD,
                             "n_matched": n_matched,
                             "launches": assoc_launches, "forward_ms": assoc_ms}}
    return report, det_gpu, as_gpu


# -------------------------------------------------------------------- slice

def _populate_store(pipe, rng, occ: int = 48, hist: int = 60) -> None:
    """Working occupancy, as bench.py sets it: ``occ`` plausible tracks with
    ``hist``-observation histories, so the associator, Sinkhorn and the
    decode run against a filled store and not the one track that seeded
    weights (whose 100 queries collapse under NMS) would spawn."""
    img_h, img_w = pipe.sequence["img_h"], pipe.sequence["img_w"]
    cap, W = pipe.cfg.max_tracks, pipe.cfg.window
    win = np.full((cap, W, 82), -1.0, np.float32)
    for t in range(occ):
        win[t, :hist, 0] = np.arange(hist)
        win[t, :hist, 1] = t % 8
        mx, my = img_w // 4, img_h // 4
        cx, cy = rng.uniform(mx, img_w - mx), rng.uniform(my, img_h - my)
        w2, h2 = rng.uniform(mx // 5 + 1, mx), rng.uniform(my // 5 + 1, my)
        win[t, :hist, 2:6] = [cx - w2, cy - h2, cx + w2, cy + h2]
        win[t, :hist, 6:9] = rng.uniform(0.3, 1.8, 3)
        win[t, :hist, 9:12] = rng.uniform(-3, 3, 3) + [0, 0, 1.2]
        win[t, :hist, 12] = rng.uniform(-3, 3)
        win[t, :hist, 13] = 0.9
        win[t, :hist, 78:82] = win[t, :hist, 2:6]
    active = np.arange(cap) < occ
    dev = lambda a, dt=None: torch.as_tensor(np.asarray(a, dt)).cuda()  # noqa: E731
    pipe.sequence["store"] = pipe.sequence["store"]._replace(
        window=dev(win),
        length=dev(np.where(active, hist, 0), np.int32),
        n_obs=dev(np.where(active, hist, 0), np.int32),
        sum_t=dev(win[:, :hist, 9:12].sum(1) * active[:, None]),
        sum_azi=dev(win[:, :hist, 12].sum(1) * active),
        sum_dims=dev(win[:, :hist, 6:9].sum(1) * active[:, None]),
        active=dev(active),
        count=dev(occ, np.int32),
        track_id=dev(np.where(active, np.arange(cap), -1), np.int32),
        last_frame=dev(np.where(active, float(hist - 1), -1.0), np.float32),
        next_id=dev(occ, np.int32),
    )


SLICE_SHAPE = (800, 1071)
SLICE_FRAMES = 8
POPULATE_SEED = 7                  # the store every slice-like phase fills at frame 2
# bf16 slice against the f32 slice, per detection row: |bf16 - f32| <= 0.02
# x max(1, |f32|).  bf16 keeps 8 significant bits (2^-8 = 0.4% a rounding);
# through ResNet-50 and 6+6 layers the full-width model's heads move by
# 0.5-1% (a CPU run of the seeded model at 800x1071: boxes 3 px of 576,
# dims 0.008, depth 0.006), so 2% leaves 2-4x headroom.
BF16_ROW_RTOL = 0.02
OFFLINE_ROW_ATOL = 1e-3            # offline rows against the online slice's


DETR_HEADS = ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size",
              "pred_depth", "pred_obj_features")
STEM_RTOL = 1e-5          # a stem rewrite against the literal conv, of the largest output


def detr_variants_run(shape=SLICE_SHAPE, devices: tuple[str, str] = ("cuda", "cpu"),
                      seed: int = VARIANTS_SEED) -> tuple[dict, dict]:
    """The slice's full-width DETR with every option the port took last:
    pre-norm, the learned-encoding option (read as JAX reads it: the sine
    encoding), the dilated last stage (stride 16: 50 x 67 = 3350 image
    tokens at 800x1071) and the s2d stem, on one frame, card against CPU
    within the DETR bar, both attention kernels launched; then the stem's
    three forms on the card on the same weights: im2col and s2d against the
    literal conv within STEM_RTOL of its largest output, and the whole DETR
    with each stem within the DETR bar of the conv stem's."""
    from odam_torch.models import detr, resnet

    card, cpu = (torch.device(d) for d in devices)
    cfg = detr.DETRConfig(pre_norm=True, position_embedding="learned", dilation=True,
                          stem="s2d")
    models = {side: detr.build_detr(cfg, seed=0, device=dev)
              for side, dev in (("card", card), ("cpu", cpu))}
    img = np.random.default_rng(seed).normal(size=(1, *shape, 3)).astype(np.float32)
    x = {side: torch.from_numpy(img).to(dev) for side, dev in (("card", card), ("cpu", cpu))}
    with torch.no_grad():
        _reset_counts()
        out = models["card"](x["card"])
        _sync(card)
        launches = _launches(card.type == "cuda")
        ms = cuda_ms(lambda: models["card"](x["card"]), reps=5, warmup=1) \
            if card.type == "cuda" else None
        ref = models["cpu"](x["cpu"])
    err = {}
    for name in DETR_HEADS:
        g, c = out[name].float().cpu(), ref[name]
        if not (torch.isfinite(g).all() and torch.allclose(g, c, atol=DETR_ATOL, rtol=DETR_RTOL)):
            raise AssertionError(f"detr_variants {name}: card vs CPU max|diff| "
                                 f"{float((g - c).abs().max()):.3e}")
        err[name] = float((g - c).abs().max())
    tokens = (shape[0] + 15) // 16 * ((shape[1] + 15) // 16)
    want = {"flash_attention": 12, "fused_attention": 6, "lap_solve": 0}
    if card.type == "cuda" and launches != want:
        raise AssertionError(f"detr_variants: launches {launches}, expected {want}")
    backbone = models["card"].backbone
    stems, heads = {}, {}
    with torch.no_grad():
        conv_out = backbone.conv1(x["card"].permute(0, 3, 1, 2))
        conv_heads = None
        for stem in ("conv", "im2col", "s2d"):
            backbone.stem = stem
            if stem != "conv":
                got = resnet.STEMS[stem](x["card"].permute(0, 3, 1, 2),
                                           backbone.conv1._compute_params()[0])
                stems[stem] = float((got - conv_out).abs().max() / conv_out.abs().max())
                if not stems[stem] <= STEM_RTOL:
                    raise AssertionError(f"detr_variants: the {stem} stem is {stems[stem]:.3e} "
                                         "of the largest output from the literal conv")
            o = models["card"](x["card"])
            if conv_heads is None:
                conv_heads = o
                continue
            for name in DETR_HEADS:
                if not torch.allclose(o[name], conv_heads[name], atol=DETR_ATOL,
                                      rtol=DETR_RTOL):
                    raise AssertionError(f"detr_variants: {name} with the {stem} stem against "
                                         "the conv stem's beyond the DETR bar")
            heads[stem] = max(float((o[n] - conv_heads[n]).abs().max()) for n in DETR_HEADS)
    del models
    return ({"phase": "detr_variants", "options": {"pre_norm": True, "dilation": True,
                                                   "position_embedding": "learned",
                                                   "stem": "s2d"},
             "image": list(shape), "image_tokens": tokens, "card_vs_cpu_max_abs": err,
             "tol": {"atol": DETR_ATOL, "rtol": DETR_RTOL, "stem_rtol": STEM_RTOL},
             "forward_ms": ms, "launches": launches,
             "stem_vs_conv_rel": stems, "heads_vs_conv_stem_max_abs": heads}, launches)


def _slice_frames(rng) -> list:
    from odam_torch.data.transforms import rgb_to_yuv420

    return [rgb_to_yuv420(rng.integers(0, 256, size=SLICE_SHAPE + (3,), dtype=np.uint8))
            for _ in range(4)]


def _reset_counts() -> None:
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.ops import lap

    ca.reset_counts()
    lap.reset_counts()


def _launches(on_card: bool = True) -> dict:
    """Every kernel's launches so far (off the card, its plain calls)."""
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.ops import lap

    if on_card:
        return {**ca.LAUNCHES, **lap.LAUNCHES}
    return {**ca.PLAIN_CALLS, **lap.PLAIN_CALLS}


def _sync_checked(fn, dev: torch.device):
    """``fn()`` under torch's sync debug mode on the card: (its result, the
    synchronizing CUDA calls it made; 0 off the card)."""
    import warnings

    if dev.type != "cuda":
        return fn(), 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum("synchronizing" in str(w.message) for w in caught)


def _launch_delta(before: dict, before_dt: dict) -> tuple[dict, dict]:
    from odam_torch.ops import cuda_attention as ca

    return ({k: n - before[k] for k, n in _launches().items()},
            {k: {d: ca.LAUNCHES_BY_DTYPE[k][d] - before_dt[k][d] for d in v}
             for k, v in ca.LAUNCHES_BY_DTYPE.items()})


def _snapshot() -> tuple[dict, dict]:
    from odam_torch.ops import cuda_attention as ca

    return _launches(), {k: dict(v) for k, v in ca.LAUNCHES_BY_DTYPE.items()}


def _check_dtype(where: str, by_dtype: dict, dtype: str) -> None:
    """Every launch counted in ``by_dtype`` is of the ``dtype`` instantiation."""
    other = {k: {d: n for d, n in v.items() if d != dtype and n} for k, v in by_dtype.items()}
    if any(other.values()):
        raise AssertionError(f"{where}: launches of another dtype than {dtype}: {by_dtype}")


def slice_run(det, assoc, frames, n_frames: int = SLICE_FRAMES, profile: bool = False,
              phase: str = "slice") -> tuple[dict, dict, object]:
    """OdamPipeline at full width over ``n_frames`` YUV frames (from frame 2
    a store of 48 tracks), every frame's kernel launches checked, and all of
    them of the models' dtype.  Returns (report, launches, pipeline)."""
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.runtime import processor

    img_h, img_w = SLICE_SHAPE
    dtype = str(det.config.dtype).replace("torch.", "")
    pipe = processor.OdamPipeline(
        det, assoc, processor.PipelineConfig(detect_threshold=0.0, score_threshold=0.0))
    pipe.init_sequence(_intrinsics(img_h, img_w), img_h, img_w)
    per_frame = []
    _reset_counts()
    for f in range(n_frames):
        if f == 2:       # after the init and the first associated step
            _populate_store(pipe, np.random.default_rng(POPULATE_SEED))
        before, before_dt = _snapshot()
        syncs = pipe.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, sync_calls = _sync_checked(
            lambda: pipe.process_frame(frames[f % 4], f, _pose(f)), pipe.device)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, by_dtype = _launch_delta(before, before_dt)
        expected = {"flash_attention": 12, "fused_attention": 6 if f == 0 else 22,
                    "lap_solve": 0 if f == 0 else 1}
        if launches != expected:
            raise AssertionError(f"{phase} frame {f}: launches {launches}, expected {expected}")
        _check_dtype(f"{phase} frame {f}", by_dtype, dtype)
        host_syncs = pipe.host_syncs - syncs
        # frame 1 waits for the store-count flag; once the store holds a
        # track (frame 2 on) a frame waits for nothing: the decode is on the card
        if f >= 2 and (host_syncs or sync_calls):
            raise AssertionError(f"{phase} frame {f}: {host_syncs} host syncs, {sync_calls} "
                                 "synchronizing CUDA calls once the store holds a track")
        per_frame.append({"frame": f, "ms": ms, "host_syncs": host_syncs,
                          "synchronizing_calls": sync_calls,
                          "n_detections": int(result.n_detections), "launches": launches})
    slice_launches = _launches()
    if any(ca.ALIGN_COPIES.values()):
        raise AssertionError(f"the {phase}'s attention inputs needed aligned copies: "
                             f"{ca.ALIGN_COPIES}")
    store = pipe.sequence["store"]
    if not (torch.isfinite(store.window).all() and torch.isfinite(pipe.sequence["log"].rows).all()):
        raise AssertionError(f"{phase}: non-finite track store or log")
    tracks = pipe.tracks
    if not per_frame[0]["n_detections"] or not tracks:
        raise AssertionError(f"the {phase} produced no detections or no tracks")
    if not all(np.isfinite(t).all() for t in tracks):
        raise AssertionError(f"{phase}: non-finite track rows")
    steady = sorted(p["ms"] for p in per_frame[2:])
    report = {"phase": phase, "dtype": dtype, "frames": n_frames, "image": [img_h, img_w],
              "transport": "yuv420", "per_frame": per_frame,
              "step_ms_median_frames_2_on": steady[len(steady) // 2],
              "n_tracks": len(tracks), "n_observations": int(sum(len(t) for t in tracks)),
              "overflow_report": pipe.overflow_report(warn=False),
              "launches": slice_launches,
              "launches_by_dtype": {k: dict(v) for k, v in ca.LAUNCHES_BY_DTYPE.items()},
              "align_copies": dict(ca.ALIGN_COPIES)}
    if profile:
        report["profile"] = profile_steps(pipe, frames, n_frames, trace=f"{phase}_trace.json")
    return report, slice_launches, pipe


def _logged(pipe, n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    log = pipe.sequence["log"]
    return log.rows[:n_frames].cpu().numpy(), log.ids[:n_frames].cpu().numpy()


def slice_bf16_run(frames, f32_pipe, f32_report, profile: bool = False) -> tuple[dict, dict]:
    """The slice with the same seeded weights in bf16: the bf16 instantiations
    of both kernels with the f32 slice's launches a frame, every frame's
    detection rows against the f32 slice's within BF16_ROW_RTOL, and the
    track ids (what the bf16 associator matched) equal to the f32 slice's."""
    from odam_torch.models import associator, detr

    det = detr.build_detr(detr.DETRConfig(dtype=torch.bfloat16), seed=0)
    assoc = associator.build_associator(associator.AssociatorConfig(dtype=torch.bfloat16), seed=1)
    report, launches, pipe = slice_run(det, assoc, frames, profile=profile, phase="slice_bf16")
    rows16, ids16 = _logged(pipe, SLICE_FRAMES)
    rows32, ids32 = _logged(f32_pipe, SLICE_FRAMES)
    n16 = [p["n_detections"] for p in report["per_frame"]]
    n32 = [p["n_detections"] for p in f32_report["per_frame"]]
    if n16 != n32:
        raise AssertionError(f"slice_bf16: detections a frame {n16}, f32 slice {n32}")
    valid = rows32[..., 0] >= 0                     # detection slots with a row
    a, b = rows32[valid][:, 1:], rows16[valid][:, 1:]
    worst = float((np.abs(b - a) / np.maximum(1.0, np.abs(a))).max())
    if not worst <= BF16_ROW_RTOL:
        raise AssertionError(f"slice_bf16: detection rows against f32 {worst:.3e} "
                             f"exceeds {BF16_ROW_RTOL} x max(1, |f32|)")
    if not np.array_equal(ids16, ids32):    # the bf16 associator's matches, exact
        raise AssertionError(f"slice_bf16: track ids {ids16[valid].tolist()} differ from "
                             f"the f32 slice's {ids32[valid].tolist()}")
    report.update({
        "rows_vs_f32": {"max_rel": worst, "tol": f"|bf16 - f32| <= {BF16_ROW_RTOL} x max(1, |f32|)",
                        "rows": int(valid.sum()),
                        "max_abs_px": float(np.abs(b[:, 1:5] - a[:, 1:5]).max())},
        "ids_equal_f32": True,
        "f32_step_ms_median_frames_2_on": f32_report["step_ms_median_frames_2_on"]})
    del det, assoc, pipe
    return report, launches


def offline_run(det_gpu, as_gpu, frames, online_pipe) -> tuple[dict, dict]:
    """The slice's 8 frames through BatchedDetector (batch 8, so the
    detector's attention takes the plain path) and the cached-detection
    pipeline, with the same store filled at frame 2: ids exact and rows
    within OFFLINE_ROW_ATOL of the online slice; launches flash 0, fused 0
    on frame 0 and 16 (the GNN) after; the detector launches none."""
    from odam_torch.data.transforms import yuv420_to_normalized_device
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.runtime import offline, processor

    img_h, img_w = SLICE_SHAPE
    cfg = processor.PipelineConfig(detect_threshold=0.0, score_threshold=0.0)
    K = _intrinsics(img_h, img_w)
    mean = torch.tensor([0.485, 0.456, 0.406], device="cuda")
    std = torch.tensor([0.229, 0.224, 0.225], device="cuda")
    # the online step's own decode of each frame, as float32 frames
    images = [yuv420_to_normalized_device(torch.from_numpy(frames[f % 4][0]).cuda(),
                                          torch.from_numpy(frames[f % 4][1]).cuda(), mean,
                                          std).cpu().numpy() for f in range(SLICE_FRAMES)]
    detector = offline.BatchedDetector(det_gpu, cfg, batch_size=SLICE_FRAMES)
    detector.detect_frames(images, K, img_w, img_h)          # warm
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = detector.detect_frames(images, K, img_w, img_h)
    torch.cuda.synchronize()
    detect_ms = (time.perf_counter() - t0) * 1e3
    detect_launches = _launches()
    if any(detect_launches.values()):
        raise AssertionError(f"offline detector at batch {SLICE_FRAMES} launched {detect_launches}")
    cached = offline.CachedDetectionPipeline(as_gpu, cfg)
    cached.init_sequence(K, img_h, img_w)
    per_frame = []
    for f, d in enumerate(dets):
        if f == 2:
            _populate_store(cached, np.random.default_rng(POPULATE_SEED))
        before, syncs = _launches(), cached.host_syncs
        _, sync_calls = _sync_checked(lambda: cached.process_detections(d, f, _pose(f)),
                                      cached.device)
        launches = {k: n - before[k] for k, n in _launches().items()}
        expected = {"flash_attention": 0, "fused_attention": 0 if f == 0 else 16,
                    "lap_solve": 0 if f == 0 else 1}
        if launches != expected:
            raise AssertionError(f"offline frame {f}: launches {launches}, expected {expected}")
        if f >= 2 and cached.host_syncs - syncs:
            raise AssertionError(f"offline frame {f}: {cached.host_syncs - syncs} host syncs "
                                 "once the store holds a track")
        per_frame.append({**launches, "host_syncs": cached.host_syncs - syncs,
                          "synchronizing_calls": sync_calls})
    rows, ids = _logged(cached, SLICE_FRAMES)
    rows_on, ids_on = _logged(online_pipe, SLICE_FRAMES)
    if not np.array_equal(ids, ids_on):
        raise AssertionError("offline track ids differ from the online slice's")
    row_err = float(np.abs(rows - rows_on).max())
    if not row_err <= OFFLINE_ROW_ATOL:
        raise AssertionError(f"offline rows against the online slice {row_err:.3e} "
                             f"exceed {OFFLINE_ROW_ATOL}")
    launches = _launches()
    report = {"phase": "offline", "frames": SLICE_FRAMES, "detect_batch": SLICE_FRAMES,
              "detect_ms_per_frame": detect_ms / SLICE_FRAMES, "detect_launches": detect_launches,
              "per_frame_launches": per_frame, "ids_equal_online": True,
              "max_row_abs_diff_online": row_err, "tol": {"atol": OFFLINE_ROW_ATOL},
              "n_tracks": len(cached.tracks), "launches": launches}
    return report, launches


# -------------------------------------------------------------------- lanes

SP_FRAMES = 8                      # frames a lane in scene_parallel_full
SP_ORDER_SEED = 11                 # the frames, and each lane's order of them


def _lane_scenes(frames, n_lanes: int, shape) -> list[dict]:
    """``n_lanes`` scenes over the same frames, each in its own order (lane
    0 in order), so that no two lanes see the same sequence."""
    n = len(frames)
    rng = np.random.default_rng(SP_ORDER_SEED)
    orders = [np.arange(n)] + [rng.permutation(n) for _ in range(n_lanes - 1)]
    if len({tuple(o) for o in orders}) != n_lanes:
        raise AssertionError("two lanes got the same order of frames")
    return [{"frames": [frames[i] for i in order], "frame_ids": list(range(n)),
             "T_wcs": [_pose(int(i)) for i in order], "K": _intrinsics(*shape)}
            for order in orders]


def _run_lanes(runner, scenes, img_h, img_w, sync_each: bool = False,
               profile_steps: tuple[int, ...] = ()) -> tuple[tuple, dict]:
    """``runner.run_frames`` with each step recorded: its host time
    (synchronized before and after when ``sync_each``), its per-lane
    detection counts (left on the device until the end), the synchronizing
    CUDA calls it made (torch's sync debug mode, on the card, when not
    ``sync_each``), and a torch.profiler window over the steps in
    ``profile_steps``.  Returns (the lane-stacked stores and logs, the
    record)."""
    from torch.profiler import ProfilerActivity, profile

    dev = runner.device
    count_syncs = dev.type == "cuda" and not sync_each
    record = {"ms": [], "n_detections": [], "synchronizing_calls": []}
    inner = runner.step
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities)

    def step(*args):
        i = len(record["ms"])
        if profile_steps and i == profile_steps[0]:
            _sync(dev)
            prof.start()
            record["profile_t0"] = time.perf_counter()
        if sync_each:
            _sync(dev)
        t0 = time.perf_counter()
        if count_syncs:
            res, n_sync = _sync_checked(lambda: inner(*args), dev)
            record["synchronizing_calls"].append(n_sync)
        else:
            res = inner(*args)
        if sync_each:
            _sync(dev)
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        record["n_detections"].append(res.n_detections)
        if profile_steps and i == profile_steps[-1]:
            _sync(dev)
            record["profile_wall_ms"] = (time.perf_counter() - record["profile_t0"]) * 1e3
            prof.stop()
            record["profile"] = prof
        return res

    runner.step = step
    try:
        state = runner.run_frames(scenes, img_h, img_w)
    finally:
        del runner.step
    _sync(dev)
    record["n_detections"] = torch.stack(record["n_detections"]).cpu().numpy()   # [F, P]
    return state, record


def _profile_summary(prof, n: int, wall_ms: float) -> dict:
    """Kernel launches and device busy time a step over ``n`` profiled steps."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("odam.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
    return {"kernel_launches_per_step": sum(e.count for e in kernels) / n,
            "device_busy_ms_per_step": busy_ms, "wall_ms_per_step": wall_ms / n,
            "device_idle_share": max(0.0, 1 - busy_ms / (wall_ms / n))}


# The pixel columns of a track row: the 2D box (2:6) and its copy (78:82).
PIXEL_COLUMNS = np.r_[2:6, 78:82]


def _hold_lane(where: str, dtype: str, rows, rows_ref, img_h: int, img_w: int) -> float:
    """A lane's logged rows against the serial f32 pipeline's.  f32: within
    DETR_ATOL / DETR_RTOL (the max |diff| returned).  bf16: within
    BF16_ROW_RTOL x max(1, |f32|) with the pixel columns in units of the
    image (x / width, y / height), the max relative diff returned.  The box
    head predicts normalized coordinates, and in bf16 one rounding of one
    near 0.5 is 2^-9, 2.1 px of a 1071-px frame: against the pixel value
    that is 2.5% of an edge at 83 px, against the frame 0.2%."""
    valid = rows_ref[..., 0] >= 0
    a, b = rows_ref[valid], rows[valid]
    if dtype == "float32":
        if not np.allclose(b, a, atol=DETR_ATOL, rtol=DETR_RTOL):
            raise AssertionError(f"{where}: rows max|diff| {np.abs(b - a).max():.3e}")
        return float(np.abs(b - a).max(initial=0.0))
    scale = np.ones(a.shape[1], np.float32)
    scale[PIXEL_COLUMNS] = [img_w, img_h, img_w, img_h] * 2
    a, b = a / scale, b / scale
    rel = float((np.abs(b[:, 1:] - a[:, 1:]) / np.maximum(1.0, np.abs(a[:, 1:]))).max(initial=0.0))
    if not rel <= BF16_ROW_RTOL:
        raise AssertionError(f"{where}: rows {rel:.3e} of f32 exceed {BF16_ROW_RTOL}")
    return rel


def scene_parallel_full_run(det_f32, as_f32, device: str = "cuda", shape=SLICE_SHAPE,
                            lanes: tuple[int, ...] = SP_LANES,
                            n_frames: int = SP_FRAMES) -> tuple[dict, dict]:
    """SceneParallelRunner at full width (the slice's seeded models and
    PipelineConfig, 800x1071 uint8 frames) at P = 1, 2, 4 and 8 lanes of 8
    frames each, every lane's frames in its own order; f32 (TF32 off), then
    bf16.  Every lane is held to the serial f32 pipeline on its frames:
    detections a frame and track ids exact, and its logged rows by
    :func:`_hold_lane` (bf16: the slice_bf16 bar, with pixels in units of
    the frame).  Each (dtype, P) runs three times: steps synchronized one by
    one, for the step time; unsynchronized, for the aggregate frames/s, with
    the kernel launches by batch, host syncs, synchronizing calls and peak
    memory counted (the counts set to 0 just before, read just after); and
    with the last two steps profiled, for the launches and device time a
    step.  Both kernels must launch at B = P only, and the launches a step
    at the most lanes must stay below twice those at one lane."""
    from odam_torch.models import associator, detr
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.runtime import processor, scene_parallel

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    img_h, img_w = shape
    cfg = processor.PipelineConfig(detect_threshold=0.0, score_threshold=0.0)
    rng = np.random.default_rng(SP_ORDER_SEED)
    frames = [rng.integers(0, 256, size=tuple(shape) + (3,), dtype=np.uint8)
              for _ in range(n_frames)]
    scenes = _lane_scenes(frames, max(lanes), shape)
    serial = []
    for s in scenes:              # the serial f32 reference of every lane's sequence
        pipe = processor.OdamPipeline(det_f32, as_f32, cfg, device=dev)
        pipe.init_sequence(s["K"], img_h, img_w)
        n = [int(pipe.process_frame(img, fid, T).n_detections)
             for img, fid, T in zip(s["frames"], s["frame_ids"], s["T_wcs"])]
        serial.append((n, *_logged(pipe, n_frames)))
        del pipe
    models = {"float32": (det_f32, as_f32),
              "bfloat16": (detr.build_detr(detr.DETRConfig(dtype=torch.bfloat16), seed=0,
                                           device=dev),
                           associator.build_associator(
                               associator.AssociatorConfig(dtype=torch.bfloat16), seed=1,
                               device=dev))}
    report = {"phase": "scene_parallel_full", "image": [img_h, img_w],
              "frames_per_lane": n_frames, "transport": "uint8", "runs": {}}
    by_batch, lap_launches = {}, {}
    for dtype, (det, assoc) in models.items():
        for P in lanes:
            where = f"scene_parallel_full {dtype} P={P}"
            runner = scene_parallel.SceneParallelRunner(det, assoc, cfg, P, device=dev)
            _, timed = _run_lanes(runner, scenes[:P], img_h, img_w, sync_each=True)
            resident = _reset_peak(dev)
            _reset_counts()
            t0 = time.perf_counter()
            (stores, logs), rec = _run_lanes(runner, scenes[:P], img_h, img_w)
            seconds = time.perf_counter() - t0
            launches = _launches(on_card)
            batches = {k: dict(v) for k, v in ca.LAUNCHES_BY_BATCH.items()}
            syncs = rec["synchronizing_calls"]
            if on_card and any(syncs[2:]):     # every lane holds a track from step 2 on
                raise AssertionError(f"{where}: synchronizing CUDA calls by step {syncs}")
            if launches["lap_solve"] != n_frames:         # every lane's decode in one launch
                raise AssertionError(f"{where}: {launches['lap_solve']} LAP launches in "
                                     f"{n_frames} steps")
            lap_launches[dtype] = lap_launches.get(dtype, 0) + launches["lap_solve"]
            peak = torch.cuda.max_memory_allocated() - resident if on_card else None
            if on_card and any(set(b) != {P} for b in batches.values()):
                raise AssertionError(f"{where}: launches by batch {batches}, not all at B = {P}")
            for name, b in batches.items():
                by_batch.setdefault(dtype, {}).setdefault(name, {})[P] = b.get(P, 0)
            if any(ca.ALIGN_COPIES.values()):
                raise AssertionError(f"{where}: aligned copies {ca.ALIGN_COPIES}")
            worst = 0.0
            for lane in range(P):
                n_ref, rows_ref, ids_ref = serial[lane]
                n = rec["n_detections"][:, lane].tolist()
                ids = logs.ids[lane, :n_frames].cpu().numpy()
                if n != n_ref or not np.array_equal(ids, ids_ref):
                    raise AssertionError(f"{where} lane {lane}: detections {n} or track ids "
                                         f"differ from the serial f32 pipeline's ({n_ref})")
                worst = max(worst, _hold_lane(f"{where} lane {lane}", dtype,
                                              logs.rows[lane, :n_frames].cpu().numpy(), rows_ref,
                                              img_h, img_w))
            if not (torch.isfinite(stores.window).all() and torch.isfinite(logs.rows).all()):
                raise AssertionError(f"{where}: non-finite track store or log")
            del stores, logs
            _, prof_rec = _run_lanes(runner, scenes[:P], img_h, img_w,
                                     profile_steps=(n_frames - 2, n_frames - 1))
            profiled = _profile_summary(prof_rec["profile"], 2, prof_rec["profile_wall_ms"])
            steady = sorted(timed["ms"][2:] or timed["ms"])
            step_ms = steady[len(steady) // 2]
            report["runs"][f"{dtype} P={P}"] = {
                "lanes": P, "dtype": dtype, "frames": P * n_frames,
                "aggregate_frames_per_s": P * n_frames / seconds, "seconds": seconds,
                "step_ms_median_steps_2_on": step_ms, "lane_frame_ms": step_ms / P,
                "step_ms": timed["ms"],
                "kernel_launches_per_step": profiled["kernel_launches_per_step"],
                "kernel_launches_per_lane_frame": profiled["kernel_launches_per_step"] / P,
                "profile": profiled,
                "host_syncs_per_step": sum(syncs) / n_frames if on_card else None,
                "synchronizing_calls_by_step": syncs,
                "peak_mbytes_above_resident": None if peak is None else peak / 1e6,
                "launches": launches, "launches_by_batch": batches,
                ("max_row_abs_diff_serial" if dtype == "float32"
                 else "max_row_rel_diff_serial_f32"): worst,
                "n_detections_per_lane": rec["n_detections"].sum(axis=0).tolist()}
            del runner
        per_step = {P: report["runs"][f"{dtype} P={P}"]["kernel_launches_per_step"]
                    for P in lanes}
        if on_card and not per_step[max(lanes)] < 2 * per_step[min(lanes)]:
            raise AssertionError(f"scene_parallel_full {dtype}: launches a step {per_step}: "
                                 f"P = {max(lanes)} not below twice P = {min(lanes)}")
    del models
    report["launches_by_batch"] = by_batch
    report["tol"] = {"float32": {"atol": DETR_ATOL, "rtol": DETR_RTOL},
                     "bfloat16": f"|bf16 - f32| <= {BF16_ROW_RTOL} x max(1, |f32|), pixel "
                                 "columns in units of the frame"}
    counts = {dtype: {**{name: sum(b.values()) for name, b in per.items()},
                      "lap_solve": lap_launches[dtype]} for dtype, per in by_batch.items()}
    return report, counts


def profile_steps(pipe, frames, first: int, n: int = 2, trace: str = "slice_trace.json") -> dict:
    """Device time by kernel over ``n`` associated steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(first, first + n):
            pipe.process_frame(frames[f % 4], f, _pose(f))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", trace))
    averages = prof.key_averages()
    on_device = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    # kernels only: an aten op's host entry repeats its kernels' time, and the
    # "odam.*" ranges appear on the device as spans (idle gaps included)
    kernels = [e for e in on_device if not e.key.startswith("odam.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
    attn_ms = sum(e.self_device_time_total for e in kernels if "attn_kernel" in e.key) / n / 1e3
    stages = {}
    for e in averages:
        if e.key.startswith("odam."):
            side = "device_span_ms" if e in on_device else "host_ms"
            total = e.device_time_total if e in on_device else e.cpu_time_total
            stages.setdefault(e.key, {})[side] = total / n / 1e3
    attention = {re.search(r"\w+_attn_kernel<[^>]*>", e.key).group(0): {
        "calls_per_step": e.count / n,
        "device_ms_per_call": e.self_device_time_total / e.count / 1e3,
    } for e in kernels if "attn_kernel" in e.key}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {"steps": n, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_launches_per_step": sum(e.count for e in kernels) / n,
            "attention_kernels_ms_per_step": attn_ms, "attention_kernels": attention,
            "stages": stages,
            "top_kernels": [{"name": e.key[:90], "ms_per_step": e.self_device_time_total / n / 1e3,
                             "calls_per_step": e.count / n} for e in top]}


# ------------------------------------------------------------------ mapping

MAP_OBJECTS, MAP_VIEWS = 64, 256
MAP_LOSS_DROP = 10.0               # the JAX drive recipe's health bars
MAP_MEAN_IOU = 0.7
MAP_CPU_ITERS, MAP_CPU_RTOL = 5, 1e-4
MAP_SEED = 3                       # the synthetic scene of both mapping phases


def _look_at(cam: np.ndarray, target: np.ndarray) -> np.ndarray:
    """T_wc of a z-up world camera at ``cam`` whose optical axis meets ``target``."""
    fwd = (target - cam) / np.linalg.norm(target - cam)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    T_wc = np.eye(4)
    T_wc[:3, 0], T_wc[:3, 1], T_wc[:3, 2], T_wc[:3, 3] = right, np.cross(fwd, right), fwd, cam
    return T_wc


def _box_corners(dims, yaw, center) -> np.ndarray:
    signs = np.array([[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
                      [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]], np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return (signs * np.asarray(dims) / 2) @ R.T + center


def synthetic_scene(rng, n_objs: int, n_views: int, img_h: int, img_w: int):
    """Ground-truth boxes on a grid over the 8 Scan2CAD classes, seen by a
    ring of look-at cameras; every view in which an object lies in front of
    the camera and inside the image gives one 82-column track row: the
    projected box clipped to the image with 1.5 px of detector noise, and
    the detector's 3D estimate, biased per object (centre sigma 15 cm, dims
    x0.8-1.2, yaw sigma 0.1 rad: a monocular detector's depth and size
    errors do not average out over views) and noisy per view (8 cm,
    x0.9-1.1, 0.05 rad).  Column 14 (a feature-code column, which the
    mapping does not read) holds the object's index.  Returns (tracks,
    frame ids, T_wcs, K, gt)."""
    side = int(np.ceil(np.sqrt(n_objs)))
    K = _intrinsics(img_h, img_w).astype(np.float64)
    gt = []
    for o in range(n_objs):
        dims = rng.uniform([0.3, 0.3, 0.4], [0.8, 0.8, 1.3])
        center = np.array([(o % side - (side - 1) / 2) * 1.1, (o // side - (side - 1) / 2) * 1.1,
                           dims[2] / 2]) + np.r_[rng.uniform(-0.1, 0.1, 2), 0.0]
        gt.append((dims, rng.uniform(-np.pi, np.pi), center, o % 8))
    bias = [(rng.normal(0, 0.2, 3), rng.uniform(0.75, 1.25, 3), rng.normal(0, 0.15))
            for _ in range(n_objs)]
    radius = 0.7 * side
    T_wcs, tracks = [], [[] for _ in range(n_objs)]
    for f in range(n_views):
        phi = 2 * np.pi * f / n_views
        T_wc = _look_at(np.array([radius * np.cos(phi), radius * np.sin(phi), 1.6]),
                        np.array([0.0, 0.0, 0.4]))
        T_wcs.append(T_wc.astype(np.float32))
        P = K @ np.linalg.inv(T_wc)[:3, :]
        for o, (dims, yaw, center, cls) in enumerate(gt):
            pix = np.c_[_box_corners(dims, yaw, center), np.ones(8)] @ P.T
            if (pix[:, 2] < 0.5).any():
                continue
            uv = pix[:, :2] / pix[:, 2:]
            box = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()])
            box = np.clip(box + rng.normal(0, 1.5, 4), 0, [img_w, img_h, img_w, img_h])
            if box[2] - box[0] < 4 or box[3] - box[1] < 4:
                continue
            row = np.full(82, -1.0, np.float32)
            row[0], row[1], row[13], row[14] = f, cls, 0.9, o
            row[2:6] = row[78:82] = box
            d_center, d_scale, d_yaw = bias[o]
            row[6:9] = dims * d_scale * rng.uniform(0.9, 1.1, 3)
            row[9:12] = center + d_center + rng.normal(0, 0.08, 3)
            row[12] = yaw + d_yaw + rng.normal(0, 0.05)
            tracks[o].append(row)
    return [np.asarray(t) for t in tracks], list(range(n_views)), T_wcs, K.astype(np.float32), gt


def _mapping_pipeline(det, assoc, cfg, device, frame_ids, T_wcs, K, img_h, img_w):
    """An OdamPipeline whose sequence holds the poses as ``process_frame``
    records them (usable frame ids, T_wc, P_cw), with no frame run."""
    from odam_torch.runtime import processor

    pipe = processor.OdamPipeline(det, assoc, cfg, device=device)
    pipe.init_sequence(K, img_h, img_w)
    seq = pipe.sequence
    for f, T_wc in zip(frame_ids, T_wcs):
        seq["usable_frames"].append(int(f))
        seq["T_wcs"].append(T_wc)
        seq["P_cws"].append(K[:3, :3] @ np.linalg.inv(T_wc)[:3, :])
    return pipe


def _iou_to_gt(out: dict, gt: list) -> list[float]:
    from odam_torch.utils.host_boxes import robust_box3d_iou

    return [robust_box3d_iou(box, _box_corners(*gt[int(track[0, 14])][:3]))
            for track, box in zip(out["tracks"], out["bboxes_qc"])]


def _first_iterations_on(device, sc, cfg, n_iters: int) -> np.ndarray:
    from odam_torch.mapping import optimizer, prior
    from odam_torch.mapping import superquadric as sq

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    init = sq.init_params(on(sc.init_translate), on(sc.init_angle), on(sc.init_dims),
                          cfg.representation)
    res = optimizer.optimize_superquadrics(
        init, on(sc.boxes), on(sc.box_mask), on(sc.view_mask), on(sc.P_cw),
        on(sc.optimize_mask), on(prior.prior_invcov_for_classes(sc.obj_class)),
        n_iters=n_iters, n_samples=cfg.optim_samples, representation=cfg.representation,
        use_prior=cfg.use_prior)
    return res.loss_log.cpu().numpy()


def solve_profile(run, n_iters: int = 10) -> dict:
    """Wall time, device busy time and kernel launches per solve iteration
    (torch.profiler over ``run(n_iters)``, a solve of ``n_iters``
    iterations at the scene's shapes, after a warm ``run(2)``)."""
    from torch.profiler import ProfilerActivity, profile

    run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_iters)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"iterations": n_iters, "wall_ms_per_iteration": wall_ms / n_iters,
            "device_busy_ms_per_iteration": busy_ms / n_iters,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_launches_per_iteration": sum(e.count for e in kernels) / n_iters,
            "top_kernels": [{"name": e.key[:80], "ms_per_iteration":
                             e.self_device_time_total / n_iters / 1e3} for e in top],
            "note": "includes the sampler set-up and the oriented-box sweep once"}


def mapping_run(rng, det, assoc, device: str = "cuda", n_objs: int = MAP_OBJECTS,
                n_views: int = MAP_VIEWS, img_h: int = 800, img_w: int = 1071,
                cpu_iters: int = MAP_CPU_ITERS, **cfg_kw) -> dict:
    """optim_process -> merge_process -> optim_process on the synthetic scene
    at the default PipelineConfig (64 objects x 256 views x 1000 samples x
    200 iterations), with the health bars checked, and the first iterations
    of the same solve on the CPU against the card."""
    from odam_torch.mapping import constraints
    from odam_torch.runtime import processor

    cfg = processor.PipelineConfig(**cfg_kw)
    tracks, frame_ids, T_wcs, K, gt = synthetic_scene(rng, n_objs, n_views, img_h, img_w)
    pipe = _mapping_pipeline(det, assoc, cfg, device, frame_ids, T_wcs, K, img_h, img_w)
    seq = pipe.sequence
    stages = {}

    def timed(name, fn, *args):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    sc = timed("constraints_ms", constraints.build_scene_constraints, tracks,
               np.asarray(seq["usable_frames"]), np.asarray(seq["P_cws"]), seq["img_h"],
               seq["img_w"], cfg.max_objs, cfg.max_views, cfg.min_views)
    first = timed("optim_process_1_ms", pipe.optim_process, tracks)
    merged = timed("merge_process_ms", pipe.merge_process, first)
    second = timed("optim_process_2_ms", pipe.optim_process, merged)

    loss = first["loss_log"]
    drop = float(loss[0] / loss[-1])
    finite = all(np.isfinite(x).all() for out in (first, second)
                 for x in (*out["bboxes_qc"], *out["bboxes_dl"], out["loss_log"],
                           *(leaf for q in out["quadrics"] for leaf in q)))
    ious = _iou_to_gt(second, gt)
    if not finite:
        raise AssertionError("non-finite mapping output")
    if drop <= MAP_LOSS_DROP:
        raise AssertionError(f"the solve's loss fell {drop:.2f}x, not more than {MAP_LOSS_DROP}x")
    if len(merged) != n_objs or float(np.mean(ious)) <= MAP_MEAN_IOU:
        raise AssertionError(f"{len(merged)} tracks after the merge (of {n_objs} objects), "
                             f"mean IoU with the ground truth {np.mean(ious):.3f}")
    card = _first_iterations_on(device, sc, cfg, cpu_iters)
    cpu = _first_iterations_on("cpu", sc, cfg, cpu_iters)
    rel = np.abs(card - cpu) / np.abs(cpu)
    if not (rel <= MAP_CPU_RTOL).all():
        raise AssertionError(f"first {cpu_iters} solve iterations, card vs CPU rel {rel}")
    report = {"phase": "mapping", "objects": n_objs, "views": n_views,
              "n_observations": int(sum(len(t) for t in tracks)),
              "shape": {"O": cfg.max_objs, "V": cfg.max_views, "S": cfg.optim_samples,
                        "iterations": cfg.optim_iters},
              **stages, "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
              "loss_drop": drop, "tracks_after_merge": len(merged),
              "mean_iou_to_gt": float(np.mean(ious)), "min_iou_to_gt": float(np.min(ious)),
              "card_vs_cpu_first_iterations": {"iterations": cpu_iters, "max_rel": float(rel.max()),
                                               "rtol": MAP_CPU_RTOL}}
    if device == "cuda":
        report["solve_profile"] = solve_profile(
            lambda n: _first_iterations_on("cuda", sc, cfg, n))
    return report


LM_ITERS = 40                      # optim_process's LM iterations: min(optim_iters, 40)
LM_MEAN_IOU = MAP_MEAN_IOU         # the Adam phase's bar
LM_MAX_FALLBACK = 16               # at most a quarter of the 64 objects left to Adam
LM_CPU_OBJECTS, LM_CPU_ITERS = 4, 3
# card vs CPU over the first LM iterations: each is a 9x9 solve from sums of
# V x 4 squared residuals in another order, and an accept/reject on their
# comparison, so a rounding difference moves a step more than an Adam
# step's 1e-4
LM_CPU_RTOL = 1e-3


def _lm_first_iterations(device, sc, cfg, n_objs: int, n_iters: int) -> np.ndarray:
    from odam_torch.mapping import lm_solver, prior
    from odam_torch.mapping import superquadric as sq

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a[:n_objs])).to(device)

    init = sq.init_params(on(sc.init_translate), on(sc.init_angle), on(sc.init_dims),
                          cfg.representation)
    res = lm_solver.optimize_superquadrics_lm(
        init, on(sc.boxes), on(sc.box_mask), on(sc.view_mask), on(sc.P_cw),
        on(sc.optimize_mask), on(prior.prior_invcov_for_classes(sc.obj_class)),
        n_iters=n_iters, n_samples=cfg.optim_samples, representation=cfg.representation,
        use_prior=cfg.use_prior)
    return res.loss_log.cpu().numpy()


def mapping_lm_run(det, assoc, adam_report: dict, device: str = "cuda",
                   n_objs: int = MAP_OBJECTS, n_views: int = MAP_VIEWS, img_h: int = 800,
                   img_w: int = 1071, cpu_objects: int = LM_CPU_OBJECTS,
                   cpu_iters: int = LM_CPU_ITERS, **cfg_kw) -> dict:
    """``optim_solver="lm"`` on the mapping phase's synthetic scene at the
    default mapping shape (64 x 256 x 1000, 40 LM iterations, the Adam
    fallback at 200): the loss falls, the mean IoU with the ground truth is
    above LM_MEAN_IOU, at most LM_MAX_FALLBACK objects fall back, and the
    first iterations of the same solve on the CPU (its first ``cpu_objects``
    objects) agree with the card's within LM_CPU_RTOL."""
    from odam_torch.mapping import constraints, lm_solver
    from odam_torch.runtime import processor

    cfg = processor.PipelineConfig(optim_solver="lm", **cfg_kw)
    tracks, frame_ids, T_wcs, K, gt = synthetic_scene(np.random.default_rng(MAP_SEED), n_objs,
                                                      n_views, img_h, img_w)
    pipe = _mapping_pipeline(det, assoc, cfg, device, frame_ids, T_wcs, K, img_h, img_w)
    seq = pipe.sequence
    stages = {}
    reads = lm_solver.HOST_READS["fallback_any"]

    def timed(name, fn, *args):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    first = timed("optim_process_1_ms", pipe.optim_process, tracks)
    merged = timed("merge_process_ms", pipe.merge_process, first)
    second = timed("optim_process_2_ms", pipe.optim_process, merged)
    loss = first["loss_log"]
    ious = _iou_to_gt(second, gt)
    finite = all(np.isfinite(x).all() for out in (first, second)
                 for x in (*out["bboxes_qc"], *out["bboxes_dl"], out["loss_log"]))
    if not finite:
        raise AssertionError("non-finite LM mapping output")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"the LM loss did not fall: {loss[0]:.4g} -> {loss[-1]:.4g}")
    if float(np.mean(ious)) <= LM_MEAN_IOU or len(merged) != n_objs:
        raise AssertionError(f"LM: {len(merged)} tracks after the merge (of {n_objs}), mean IoU "
                             f"with the ground truth {np.mean(ious):.3f}")
    fallback = [first["n_fallback"], second["n_fallback"]]
    if max(fallback) > LM_MAX_FALLBACK:
        raise AssertionError(f"LM: {fallback} objects fell back to Adam, more than "
                             f"{LM_MAX_FALLBACK}")
    sc = constraints.build_scene_constraints(
        tracks, np.asarray(seq["usable_frames"]), np.asarray(seq["P_cws"]), seq["img_h"],
        seq["img_w"], cfg.max_objs, cfg.max_views, cfg.min_views)
    card = _lm_first_iterations(device, sc, cfg, cpu_objects, cpu_iters)
    cpu = _lm_first_iterations("cpu", sc, cfg, cpu_objects, cpu_iters)
    rel = np.abs(card - cpu) / np.abs(cpu)
    if not (rel <= LM_CPU_RTOL).all():
        raise AssertionError(f"first {cpu_iters} LM iterations, card vs CPU rel {rel}")
    report = {"phase": "mapping_lm", "objects": n_objs, "views": n_views,
              "shape": {"O": cfg.max_objs, "V": cfg.max_views, "S": cfg.optim_samples,
                        "lm_iterations": min(cfg.optim_iters, LM_ITERS),
                        "adam_fallback_iterations": cfg.optim_iters},
              **stages, "adam_optim_process_1_ms": adam_report["optim_process_1_ms"],
              "adam_optim_process_2_ms": adam_report["optim_process_2_ms"],
              "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
              "loss_drop": float(loss[0] / loss[-1]), "tracks_after_merge": len(merged),
              "mean_iou_to_gt": float(np.mean(ious)), "min_iou_to_gt": float(np.min(ious)),
              "adam_mean_iou_to_gt": adam_report["mean_iou_to_gt"],
              "n_fallback": fallback, "max_fallback": LM_MAX_FALLBACK,
              "host_reads": lm_solver.HOST_READS["fallback_any"] - reads,
              "card_vs_cpu_first_iterations": {"objects": cpu_objects, "iterations": cpu_iters,
                                               "max_rel": float(rel.max()), "rtol": LM_CPU_RTOL}}
    if device == "cuda":
        report["solve_profile"] = solve_profile(
            lambda n: _lm_first_iterations("cuda", sc, cfg, cfg.max_objs, n), n_iters=5)
    return report


# -------------------------------------------------------------------- scene

SCENE_DATA = os.path.join("examples", "cli_rehearsal", "data_hard")
SCENE_QC_IOU = 0.95      # card vs CPU per object (the solve's own spread; see below)
SCENE_ROW_ATOL = 1e-3    # card vs CPU track rows, tests/test_torch_cli.py's bar


def _scene_flags() -> tuple[list[str], list[str]]:
    """The hard split's scenes and the flags of the scene phase's CLI runs."""
    split = os.path.join(SCENE_DATA, "val.txt")
    with open(split) as f:
        scenes = f.read().split()
    return scenes, ["--config_path", os.path.join(SCENE_DATA, "rehearsal.yaml"),
                    "--scans_root", os.path.join(SCENE_DATA, "scans"), "--sequences", split,
                    "--detector_ckpt",
                    os.path.join("artifacts", "torch", "rehearsal_hard_detr.npz"),
                    "--associator_ckpt",
                    os.path.join("artifacts", "torch", "rehearsal_hard_assoc.npz"),
                    "--short_side", "192", "--max_size", "192", "--max_objs", "32",
                    "--max_views", "32", "--dtype", "float32"]


def _f1(result_dir: str, scenes: list[str]) -> dict:
    from odam_torch.eval import scan2cad

    return scan2cad.evaluate(result_dir, os.path.join(SCENE_DATA, "full_annotations.json"),
                             os.path.join(SCENE_DATA, "scans"), scenes, min_views=10,
                             verbose=False)


def _write_results(out_dir: str, scenes: list[str], outs: list[dict]) -> None:
    """The CLI's pickles of ``outs``, one per scene."""
    import pickle

    for seq_id, out in zip(scenes, outs):
        os.makedirs(os.path.join(out_dir, seq_id), exist_ok=True)
        with open(os.path.join(out_dir, seq_id, seq_id), "wb") as f:
            pickle.dump({k: out[k] for k in ("tracks", "bboxes_qc", "bboxes_dl", "quadrics")}, f)


def _compare_results(where: str, got: list[dict], want: list[dict]) -> dict:
    """Tracks of each scene: the same count and order, frame ids and classes
    exact, rows within SCENE_ROW_ATOL; bboxes_qc IoU reported."""
    from odam_torch.utils.host_boxes import robust_box3d_iou

    rows, ious = 0.0, []
    for k, (g, w) in enumerate(zip(got, want)):
        if len(g["tracks"]) != len(w["tracks"]):
            raise AssertionError(f"{where} scene {k}: {len(g['tracks'])} tracks, "
                                 f"{len(w['tracks'])} serial")
        for a, b in zip(g["tracks"], w["tracks"]):
            if a.shape != b.shape or not np.array_equal(a[:, :2], b[:, :2]):
                raise AssertionError(f"{where} scene {k}: track frame ids or classes differ")
            rows = max(rows, float(np.abs(a - b).max()))
        ious += [robust_box3d_iou(a, b) for a, b in zip(g["bboxes_qc"], w["bboxes_qc"])]
    if not rows <= SCENE_ROW_ATOL:
        raise AssertionError(f"{where}: rows max|diff| {rows:.3e} exceed {SCENE_ROW_ATOL}")
    return {"max_row_abs_diff": rows, "min_qc_iou": min(ious, default=1.0),
            "tracks": [len(g["tracks"]) for g in got]}


def scene_parallel_hard_run(scene_f1: dict, out_root: str = os.path.join("chiprun_out", "sp_hard"),
                            device: str = "cuda", lanes: tuple[int, ...] = (3, 4),
                            max_frames: int | None = None) -> tuple[dict, dict]:
    """SceneParallelRunner on the committed hard split (3 scenes x 32 frames
    at 192x192) with the committed weights and the scene phase's flags, at
    P = 3 and then P = 4 (one lane of padding), against the serial
    OdamPipeline on the same frames and device: tracks of every scene with
    frame ids and classes exact and rows within SCENE_ROW_ATOL, and the F1
    table equal to the scene phase's (``scene_f1``).  fused_attention must
    launch at B = P (144 image tokens: no flash)."""
    from odam_torch import config as config_mod
    from odam_torch.data import scannet
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.runtime import processor, scene_parallel
    from odam_torch.scripts import run_processor

    scene_ids, flags = _scene_flags()
    args = run_processor.build_parser().parse_args(
        flags + (["--max_frames", str(max_frames)] if max_frames else []))
    dev = torch.device(device)
    det, assoc = run_processor.build_models(config_mod.merge_cfg([args.config_path]),
                                            args.detector_ckpt, args.associator_ckpt, "exact",
                                            dev, torch.float32)
    cfg = run_processor.pipeline_config(args)
    index = scannet.SceneIndex(args.scans_root, scene_ids)
    scenes = [run_processor.scene_inputs(index, s, args) for s in scene_ids]
    img_h, img_w = scenes[-1]["size"]
    pipe = processor.OdamPipeline(det, assoc, cfg, device=dev)
    serial = []
    t0 = time.perf_counter()
    for s in scenes:
        pipe.init_sequence(s["K"], img_h, img_w)
        for i in range(len(s["frames"])):
            pipe.process_frame(s["frames"][i], s["frame_ids"][i], s["T_wcs"][i])
        out = pipe.optim_process(pipe.tracks)
        serial.append(pipe.optim_process(pipe.merge_process(out)))
    serial_s = time.perf_counter() - t0
    _write_results(os.path.join(out_root, "serial"), scene_ids, serial)
    report = {"phase": "scene_parallel_hard", "device": device,
              "frames": [len(s["frames"]) for s in scenes], "serial_seconds": serial_s,
              "f1_serial": _f1(os.path.join(out_root, "serial"), scene_ids)["average"], "lanes": {}}
    counts = {name: 0 for name in _launches()}
    for P in lanes:
        _reset_counts()
        runner = scene_parallel.SceneParallelRunner(det, assoc, cfg, P, device=dev)
        t0 = time.perf_counter()
        outs = runner.run_scenes(scenes, img_h, img_w)
        seconds = time.perf_counter() - t0
        launched = _launches(dev.type == "cuda")
        by_batch = {k: dict(v) for k, v in ca.LAUNCHES_BY_BATCH.items()}
        if dev.type == "cuda" and (by_batch["fused_attention"].get(P, 0) == 0
                                   or launched["flash_attention"]):
            raise AssertionError(f"scene_parallel_hard P={P}: launches by batch {by_batch}")
        out_dir = os.path.join(out_root, f"P{P}")
        _write_results(out_dir, scene_ids, outs)
        f1 = _f1(out_dir, scene_ids)
        if f1 != scene_f1:
            raise AssertionError(f"scene_parallel_hard P={P}: F1 {f1['average']} differs from "
                                 f"the scene phase's {scene_f1['average']}")
        report["lanes"][f"P={P}"] = {
            **_compare_results(f"scene_parallel_hard P={P}", outs, serial),
            "seconds": seconds, "f1_equals_scene": True, "f1": f1["average"],
            "launches": launched, "launches_by_batch": by_batch,
            "overflow_reports": [o["overflow_report"] for o in outs]}
        for name in counts:
            counts[name] += launched[name]
    return report, counts


def cli_scene_parallel_run(scene_f1: dict, out_root: str = os.path.join("chiprun_out", "cli_sp"),
                           device: str = "cuda", n_lanes: int = 3) -> tuple[dict, dict]:
    """``run_processor --scene_parallel 3`` on the hard split with the scene
    phase's flags, then ``eval_scan2cad``: its F1 table must equal the scene
    phase's, and fused_attention must launch at B = 3."""
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.scripts import eval_scan2cad, run_processor

    scene_ids, flags = _scene_flags()
    _reset_counts()
    t0 = time.perf_counter()
    if run_processor.main(flags + ["--out_dir", out_root, "--device", device,
                                   "--scene_parallel", str(n_lanes)]) != 0:
        raise AssertionError("run_processor --scene_parallel failed")
    seconds = time.perf_counter() - t0
    counts = _launches(device == "cuda")
    by_batch = {k: dict(v) for k, v in ca.LAUNCHES_BY_BATCH.items()}
    if device == "cuda" and by_batch["fused_attention"].get(n_lanes, 0) == 0:
        raise AssertionError(f"cli_scene_parallel: launches by batch {by_batch}")
    f1 = eval_scan2cad.main(["--result_dir", out_root,
                             "--scan2cad", os.path.join(SCENE_DATA, "full_annotations.json"),
                             "--scans_root", os.path.join(SCENE_DATA, "scans"),
                             "--val_split", os.path.join(SCENE_DATA, "val.txt"),
                             "--min_views", "10"])
    if f1 != scene_f1:
        raise AssertionError(f"cli_scene_parallel: F1 {f1['average']} differs from the scene "
                             f"phase's {scene_f1['average']}")
    return ({"phase": "cli_scene_parallel", "lanes": n_lanes, "scenes": len(scene_ids),
             "seconds": seconds, "f1": f1["average"], "f1_equals_scene": True,
             "launches": counts, "launches_by_batch": by_batch}, counts)


def _counts_of(dev: torch.device) -> tuple[dict, dict]:
    """The kernel counters of ``dev`` as they stand: launches on the card,
    plain calls on the CPU, and the attention's split by dtype."""
    from odam_torch.ops import cuda_attention as ca

    by_dtype = ca.LAUNCHES_BY_DTYPE if dev.type == "cuda" else ca.PLAIN_CALLS_BY_DTYPE
    return _launches(dev.type == "cuda"), {k: dict(v) for k, v in by_dtype.items()}


def _counted(dev: torch.device, fn, *args):
    """``fn(*args)`` and the kernel calls it made on ``dev``: (result,
    calls by kernel, attention calls by kernel and dtype)."""
    before, before_dt = _counts_of(dev)
    result = fn(*args)
    after, after_dt = _counts_of(dev)
    return (result, {k: n - before[k] for k, n in after.items()},
            {k: {d: n - before_dt[k][d] for d, n in v.items()} for k, v in after_dt.items()})


def _run_cli(argv: list[str]) -> tuple[list[dict], dict, float]:
    """``odam_torch.scripts.run_processor.main`` with every frame's kernel
    launches (or, on the CPU, plain calls), by dtype too, and every scene's
    wall time (frames, solve, merge, solve) recorded.  A frame is a call of
    ``process_frame`` or, offline, of ``process_detections``; the offline
    detector's batches are recorded as entries with ``"detect": True``."""
    from odam_torch.runtime import offline, processor
    from odam_torch.scripts import run_processor

    frames, scene_s = [], {}
    inner = {"frame": processor.OdamPipeline.process_frame,
             "dets": offline.CachedDetectionPipeline.process_detections,
             "detect": offline.BatchedDetector.detect_frames,
             "scene": run_processor.run_scene}

    def recorded(kind):
        def call(obj, *args):
            result, entry, by_dtype = _counted(obj.device, inner[kind], obj, *args)
            entry["by_dtype"] = by_dtype
            if kind == "detect":
                entry.update(detect=True, frames=len(args[0]))
            else:
                entry.update(frame=int(args[1]), associated=obj.sequence["has_tracks"],
                             exact_decode=obj.associator.config.decode == "exact")
            frames.append(entry)
            return result
        return call

    def timed_scene(pipe, index, seq_id, args, detector=None):
        t0 = time.perf_counter()
        out = inner["scene"](pipe, index, seq_id, args, detector)
        scene_s[seq_id] = time.perf_counter() - t0      # ends in host copies: synchronised
        return out

    processor.OdamPipeline.process_frame = recorded("frame")
    offline.CachedDetectionPipeline.process_detections = recorded("dets")
    offline.BatchedDetector.detect_frames = recorded("detect")
    run_processor.run_scene = timed_scene
    try:
        t0 = time.perf_counter()
        if run_processor.main(argv) != 0:
            raise AssertionError(f"run_processor {' '.join(argv)} failed")
        return frames, scene_s, time.perf_counter() - t0
    finally:
        processor.OdamPipeline.process_frame = inner["frame"]
        offline.CachedDetectionPipeline.process_detections = inner["dets"]
        offline.BatchedDetector.detect_frames = inner["detect"]
        run_processor.run_scene = inner["scene"]


def scene_run(out_root: str = os.path.join("chiprun_out", "scene"),
              devices: tuple[str, str] = ("cuda", "cpu")) -> tuple[dict, dict]:
    """The CLI chain on the committed hard split's three scenes with the
    committed weights, on the card and on the CPU; eval_scan2cad on both.

    Card and CPU must give the same tracks per scene (frame ids and classes
    exact, every row within atol 1e-3), bboxes_qc within IoU 0.95 per
    object, and the same F1 table.  The IoU bar is the solve's own spread:
    the Adam solve chatters across the kinks of its L1-of-maxima loss, so
    two float orders end up to a few percent of IoU apart
    (tests/test_torch_mapping.py); the rows, which the solve does not
    touch, hold the online step to the tighter bar.  Launches per frame:
    fused 6 before the store holds a track (2 encoder self, 2 decoder self,
    2 decoder cross; 144 image tokens are below FLASH_MIN_KEYS), 14 after
    (adding 4 GNN layers x 2 directions; the history fuser runs at batch 64,
    over KERNEL_MAX_BATCH, on the plain path), flash 0.
    """
    import pickle

    from odam_torch.eval import scan2cad
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.utils.host_boxes import robust_box3d_iou

    scenes, common = _scene_flags()
    runs, results, f1 = {}, {}, {}
    for device in devices:
        out_dir = os.path.join(out_root, device)
        _reset_counts()
        frames, scene_s, seconds = _run_cli(common + ["--out_dir", out_dir, "--device", device])
        runs[device] = {"frames": frames, "seconds": seconds, "scene_seconds": scene_s,
                        "counts": _launches(device == "cuda")}
        results[device] = {}
        for s in scenes:
            with open(os.path.join(out_dir, s, s), "rb") as f:
                results[device][s] = pickle.load(f)
        f1[device] = scan2cad.evaluate(out_dir, os.path.join(SCENE_DATA, "full_annotations.json"),
                                       os.path.join(SCENE_DATA, "scans"), scenes,
                                       min_views=10, verbose=device == devices[0])
    card, cpu = devices
    per_scene = {}
    for s in scenes:
        g, c = results[card][s], results[cpu][s]
        if len(g["tracks"]) != len(c["tracks"]):
            raise AssertionError(f"{s}: {len(g['tracks'])} tracks on the card, "
                                 f"{len(c['tracks'])} on the CPU")
        ious = []
        for tg, tc, bg, bc in zip(g["tracks"], c["tracks"], g["bboxes_qc"], c["bboxes_qc"]):
            if tg.shape != tc.shape or not np.array_equal(tg[:, :2], tc[:, :2]):
                raise AssertionError(f"{s}: track frame ids or classes differ")
            ious.append(robust_box3d_iou(bg, bc))
        row_diff = max((float(np.abs(a - b).max()) for a, b in zip(g["tracks"], c["tracks"])),
                       default=0.0)
        if min(ious, default=1.0) < SCENE_QC_IOU:
            raise AssertionError(f"{s}: bboxes_qc card vs CPU IoU {min(ious):.4f}")
        if not row_diff <= SCENE_ROW_ATOL:
            raise AssertionError(f"{s}: track rows card vs CPU max|diff| {row_diff:.3e} "
                                 f"exceeds {SCENE_ROW_ATOL}")
        per_scene[s] = {"tracks": len(g["tracks"]), "min_qc_iou_card_vs_cpu": min(ious, default=1.0),
                        "max_row_abs_diff": row_diff}
    if f1[card] != f1[cpu]:
        raise AssertionError(f"F1 differs: card {f1[card]['average']}, cpu {f1[cpu]['average']}")
    for device, run in runs.items():
        for fr in run["frames"]:
            want = {"flash_attention": 0, "fused_attention": 14 if fr["associated"] else 6,
                    "lap_solve": int(fr["associated"] and fr["exact_decode"])}
            got = {k: fr[k] for k in want}
            if got != want:
                raise AssertionError(f"{device} frame {fr['frame']}: attention calls {got}, "
                                     f"expected {want}")
    frames = runs[card]["frames"]
    report = {"phase": "scene", "scenes": per_scene, "f1": f1[card],
              "f1_card_equals_cpu": True,
              "seconds": {d: r["seconds"] for d, r in runs.items()},
              "scene_seconds": {d: r["scene_seconds"] for d, r in runs.items()},
              "frames": len(frames), "associated_frames": sum(fr["associated"] for fr in frames),
              "launches": runs[card]["counts"], "cpu_plain_calls": runs[cpu]["counts"]}
    return report, runs[card]["counts"]


CLI_FULL_SCENE = "scene9700_00"
CLI_FULL_FRAMES = 4


def _expected_cli_calls(entry: dict, offline: bool) -> dict:
    """Attention calls a CLI frame makes at full width: online, flash 12 (6
    encoder self, 6 decoder cross) and fused 6 (decoder self) and 16 more (8
    GNN layers x 2 directions) once the store holds a track; offline, the
    detector's batch is above KERNEL_MAX_BATCH (no call) and a frame makes
    the 16 GNN calls once the store holds a track.  Such a frame launches the
    LAP kernel once with the exact decode (not with ``--profile fast``'s
    greedy one)."""
    if entry.get("detect"):
        return {"flash_attention": 0, "fused_attention": 0, "lap_solve": 0}
    gnn = 16 if entry["associated"] else 0
    lap_solve = int(entry["associated"] and entry["exact_decode"])
    if offline:
        return {"flash_attention": 0, "fused_attention": gnn, "lap_solve": lap_solve}
    return {"flash_attention": 12, "fused_attention": 6 + gnn, "lap_solve": lap_solve}


def cli_full_run(out_root: str = os.path.join("chiprun_out", "cli_full"), device: str = "cuda",
                 short_side: int = 800, n_frames: int = CLI_FULL_FRAMES,
                 extra: tuple[str, ...] = ("--dtype", "float32"),
                 phase: str = "cli_full") -> tuple[dict, dict]:
    """``run_processor`` at full width: configs/detr_scan_net.yaml (ResNet-50
    DETR, 8-layer GNN) with seeded weights, the first ``n_frames`` frames of
    one committed scene resized from 192x192 to 800x800 (625 image tokens),
    and the default mapping capacity (64 x 256 x 1000 x 200).  Detection
    and attach thresholds are 0, so that seeded weights start tracks on
    frame 0 and the associator runs on every later frame; ``--min_views 2``
    so that the solve's boxes, not the detector averages, come out.
    ``extra`` selects the path: ``cli_full`` is the f32 online step with the
    host resize, ``cli_fast`` ``--profile fast --device_resize`` in bf16
    (the step resizes the raw 192x192 frames), ``cli_offline``
    ``--offline --detect_batch 4 --solver lm`` in bf16.  Every frame's
    launches are checked (``_expected_cli_calls``), all of the run's dtype;
    the history fuser is over KERNEL_MAX_BATCH, on the plain path."""
    import pickle

    from odam_torch.ops import cuda_attention as ca

    os.makedirs(out_root, exist_ok=True)
    split = os.path.join(out_root, "split.txt")
    with open(split, "w") as f:
        f.write(CLI_FULL_SCENE + "\n")
    argv = ["--config_path", os.path.join("configs", "detr_scan_net.yaml"),
            "--scans_root", os.path.join(SCENE_DATA, "scans"), "--sequences", split,
            "--detector_ckpt", "", "--associator_ckpt", "",
            "--short_side", str(short_side), "--max_frames", str(n_frames),
            "--detect_threshold", "0.0", "--attach_threshold", "0.0", "--min_views", "2",
            "--out_dir", out_root, "--device", device, *extra]
    offline = "--offline" in extra
    dtype = extra[extra.index("--dtype") + 1] if "--dtype" in extra else "bfloat16"
    _reset_counts()
    entries, scene_s, seconds = _run_cli(argv)
    counts = _launches(device == "cuda")
    frames = [e for e in entries if not e.get("detect")]
    if len(frames) != n_frames or not any(fr["associated"] for fr in frames):
        raise AssertionError(f"{phase}: {len(frames)} frames, "
                             f"{sum(fr['associated'] for fr in frames)} associated")
    for fr in entries:
        want = _expected_cli_calls(fr, offline)
        got = {k: fr[k] for k in want}
        if got != want:
            raise AssertionError(f"{phase} {fr}: attention calls {got}, expected {want}")
        _check_dtype(f"{phase} frame {fr.get('frame')}", fr["by_dtype"], dtype)
    with open(os.path.join(out_root, CLI_FULL_SCENE, CLI_FULL_SCENE), "rb") as f:
        out = pickle.load(f)
    if not out["tracks"] or len(out["bboxes_qc"]) != len(out["tracks"]):
        raise AssertionError(f"{phase}: {len(out['tracks'])} tracks, "
                             f"{len(out['bboxes_qc'])} boxes")
    if not all(np.isfinite(x).all() for x in (*out["tracks"], *out["bboxes_qc"],
                                              *out["bboxes_dl"])):
        raise AssertionError(f"{phase}: non-finite tracks or boxes")
    report = {"phase": phase, "flags": list(extra), "dtype": dtype, "scene": CLI_FULL_SCENE,
              "frames": len(frames), "short_side": short_side,
              "associated_frames": sum(fr["associated"] for fr in frames),
              "tracks": len(out["tracks"]), "seconds": seconds, "scene_seconds": scene_s,
              "launches": counts, "align_copies": dict(ca.ALIGN_COPIES)}
    return report, counts


# ----------------------------------------------------------------- training

TRAIN_CONFIG = os.path.join("configs", "detr_scan_net.yaml")
TRAIN_CHECK = (2, 256, 320)        # the card-vs-CPU f32 step: batch, height, width
TRAIN_SHAPE = (8, 512, 672)        # train_detector's defaults
TRAIN_STEPS = {"train_detector": 10, "train_assoc": 20}
TRAIN_LOSS_RTOL = 1e-4             # card vs CPU, one f32 step with TF32 off
# Each leaf's f32 gradient, relative norm.  The detector's is held to a
# float64 CPU step, with the card's convolutions PyTorch's own: its ResNet
# weight gradients cancel over the image, so the CPU's f32 is 5.7e-4 from
# float64 there, the card's 5.8e-4 with PyTorch's convolutions and 1.01e-3
# with cuDNN's f32 ones (TF32 off; deterministic or not).  The cuDNN step,
# the one training takes, is held by its loss and its errors reported.
TRAIN_GRAD_RTOL = 1e-3
# A leaf whose CPU gradient is below this share of the global norm has no
# gradient but for rounding (softmax ignores a shift common to all keys, so
# no key bias gets one; the first decoder layer's self-attention sees equal
# values for all keys): its card gradient must be as small.
GRAD_NOISE_SHARE = 1e-6
HOST_BOUND_IDLE = 0.5              # device idle above this share of a step: host-bound


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _grad_errors(model, ref) -> dict:
    """Each trained leaf's gradient in ``model`` against ``ref``'s (same
    names), in relative norm: the worst leaf and the count of leaves whose
    reference gradient is rounding noise (GRAD_NOISE_SHARE), where
    ``model``'s must be as small."""
    g_ref = {k: p.grad.double() for k, p in ref.named_parameters() if p.grad is not None}
    g = {k: p.grad.cpu().double() for k, p in model.named_parameters() if p.grad is not None}
    if set(g_ref) != set(g) or not g_ref:
        raise AssertionError("the two models trained different leaves")
    scale = float(torch.sqrt(sum((x ** 2).sum() for x in g_ref.values())))
    worst, worst_key, noise = 0.0, None, 0
    for k, r in g_ref.items():
        ref_norm, err = float(r.norm()), float((g[k] - r).norm())
        if ref_norm <= GRAD_NOISE_SHARE * scale:
            if float(g[k].norm()) > GRAD_NOISE_SHARE * scale:
                raise AssertionError(f"{k}: a rounding-noise gradient in the reference, "
                                     f"{float(g[k].norm()):.3e} here")
            noise += 1
        elif err / ref_norm > worst:
            worst, worst_key = err / ref_norm, k
    return {"leaves": len(g_ref), "max_rel_err": worst, "worst_leaf": worst_key,
            "noise_leaves": noise, "global_norm": scale}


def _as_float64(model):
    """The model in float64 throughout (parameters, buffers and every
    layer's compute dtype): a reference for float32 gradients."""
    model = model.double()
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return model


def _reset_peak(dev) -> int:
    """Free what earlier phases left and reset the peak-memory count; the
    bytes still allocated (the model, its optimizer state and the batch),
    which the step's peak is reported above."""
    if torch.device(dev).type != "cuda":
        return 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _timed_steps(step, n: int, dev) -> tuple[list[float], list[float]]:
    """Host ms of each of ``n`` steps, each ending in a synchronize, and
    each step's loss (read after the timing)."""
    ms, losses = [], []
    for _ in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(step())
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, [float(x) for x in losses]


def train_profile(step, n: int = 2) -> dict:
    """torch.profiler over ``n`` steps: wall and device-busy time a step,
    kernel launches, the top kernels, and whether the host or the device
    bounds the step (host when the device idles over HOST_BOUND_IDLE)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
    idle = max(0.0, 1 - busy_ms / wall_ms)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"steps": n, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": idle, "bound_by": "host" if idle > HOST_BOUND_IDLE else "device",
            "kernel_launches_per_step": sum(e.count for e in kernels) / n,
            "top_kernels": [{"name": e.key[:80], "ms_per_step": e.self_device_time_total / n / 1e3,
                             "calls_per_step": e.count / n} for e in top]}


def _train_report(phase, model, state, before, ms, losses, syncs, samples, peak, resident,
                  launches, dev, frozen_label) -> dict:
    """The fields both train phases report, and their checks: the loss
    falls, frozen leaves are bit-equal, every leaf that gets a gradient
    (above GRAD_NOISE_SHARE of the last step's global norm) moved, no
    attention kernel launched.  (A leaf with no gradient, such as the first
    decoder layer's self-attention value kernel, whose input is all zeros,
    moves by weight decay alone, lr x wd of itself: below float32's
    resolution at lr 1e-4.)"""
    from odam_torch.models import convert

    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    scale = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    frozen, moved, no_grad, still = 0, 0, 0, []
    for key, t in model.state_dict().items():
        if frozen_label(convert.flax_path(model, key)) == "frozen":
            frozen += 1
            if not torch.equal(t, before[key]):
                raise AssertionError(f"{phase}: frozen {key} moved")
        elif float(grads[key].norm()) <= GRAD_NOISE_SHARE * scale:
            no_grad += 1
        elif torch.equal(t, before[key]):
            still.append(key)
        else:
            moved += 1
    if still:
        raise AssertionError(f"{phase}: trained leaves did not move: {still[:4]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    attention = {k: n for k, n in launches.items() if k != "lap_solve"}
    if any(attention.values()):
        raise AssertionError(f"{phase}: attention kernels launched {attention}")
    median = float(np.median(ms[1:]))
    return {"phase": phase, "steps": len(ms), "step_ms": ms, "step_median_ms": median,
            "samples_per_s": samples / median * 1e3,
            "max_memory_allocated": None if peak is None else peak + resident,
            "step_peak_memory_bytes": peak, "resident_bytes": resident,
            "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
            "host_syncs_per_step": syncs / len(ms), "frozen_leaves_bit_equal": frozen,
            "trained_leaves_moved": moved, "trained_leaves_without_gradient": no_grad,
            "attention_launches": attention, "lap_launches_per_step": launches["lap_solve"] / len(ms),
            "step_counter": state.step, "device": str(dev)}


def train_detector_run(device: str = "cuda", check=TRAIN_CHECK, shape=TRAIN_SHAPE,
                       n_steps: int = TRAIN_STEPS["train_detector"]) -> tuple[dict, dict]:
    """The detector's train step at full width (configs/detr_scan_net.yaml:
    ResNet-50, hidden 256, 8 heads, 6+6 layers, 100 queries, aux losses),
    on the plain attention path as JAX trains.

    First one f32 step (TF32 off) on the card and on the CPU from the same
    weights and batch (``check``), the card under the CPU's match, with and
    without cuDNN: the losses within TRAIN_LOSS_RTOL, each leaf's gradient
    without cuDNN within TRAIN_GRAD_RTOL of a float64 CPU step's; dropout
    is 0 there, since each device draws its masks from its own generator.
    Then ``n_steps`` bf16 steps at ``shape`` on one fixed synthetic batch at
    the config's dropout, timed on the host clock, and two more profiled."""
    import dataclasses

    from odam_torch import config as config_mod
    from odam_torch.models import criterion, detr, matcher, training
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.scripts.train_detector import synthetic_batches

    dev = torch.device(device)
    cfg = config_mod.merge_cfg([TRAIN_CONFIG])
    dcfg = detr.DETRConfig.from_cfg(cfg, use_kernels=False)
    tcfg = training.DetrTrainConfig(
        lr=float(cfg.get("lr", 1e-4)), lr_backbone=float(cfg.get("lr_backbone", 1e-5)),
        criterion=criterion.CriterionConfig(num_classes=dcfg.num_classes,
                                            eos_coef=float(cfg.get("eos_coef", 0.1))))
    _reset_counts()

    def batch(b, h, w, on):
        images, targets = next(synthetic_batches(b, h, w, dcfg.num_classes, 8,
                                                 np.random.default_rng(0)))
        return (torch.from_numpy(images).to(on),
                criterion.Targets(*[torch.from_numpy(x).to(on) for x in targets]))

    class RecordingMatcher(matcher.HungarianMatcher):
        def __call__(self, *args):
            self.last = super().__call__(*args)
            return self.last

    # the CPU's f32 step first (its match is every side's), a float64 CPU
    # reference, then the card with PyTorch's own convolutions and with
    # cuDNN's (which training uses)
    f32 = dataclasses.replace(dcfg, dropout=0.0)
    sides = (("cpu", "cpu", True), ("f64", "cpu", True), ("card", dev, False),
             ("card_cudnn", dev, True))
    models, check_loss, cpu_match = {}, {}, RecordingMatcher(tcfg.criterion.matcher)
    for side, on, cudnn in sides:
        model = detr.build_detr(f32, seed=0, device=on)
        if side == "f64":
            model = _as_float64(model)
        state = training.init_train_state(model, training.make_detr_optimizer(model, tcfg))
        step = training.make_detr_train_step(tcfg, matcher=cpu_match)
        images, targets = batch(*check, on)
        if side == "f64":
            images = images.double()
            targets = criterion.Targets(*[t.double() if t.is_floating_point() else t
                                          for t in targets])
        matches = None if side == "cpu" else [m.to(on) for m in cpu_match.last]
        torch.backends.cudnn.enabled = cudnn
        try:
            check_loss[side] = float(step(state, images, targets, matches=matches)["total"])
        finally:
            torch.backends.cudnn.enabled = True
        models[side] = model
    cpu_loss, card_loss = check_loss["cpu"], check_loss["card"]
    loss_err = {side: abs(check_loss[side] - cpu_loss) / abs(cpu_loss)
                for side in ("card", "card_cudnn")}
    if not max(loss_err.values()) <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train_detector: losses {check_loss}")
    grads = {f"{a}_vs_{b}": _grad_errors(models[a], models[b])
             for a, b in (("card", "f64"), ("cpu", "f64"), ("card_cudnn", "f64"),
                          ("card", "cpu"), ("card_cudnn", "cpu"))}
    if grads["card_vs_f64"]["max_rel_err"] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"train_detector: card gradients {grads['card_vs_f64']}")
    del models

    model = detr.build_detr(dataclasses.replace(dcfg, dtype=torch.bfloat16), seed=0,
                            device=dev)
    state = training.init_train_state(model, training.make_detr_optimizer(model, tcfg))

    class CountingMatcher(matcher.HungarianMatcher):
        """The matcher with its synchronizing CUDA calls counted."""
        syncs = 0

        def __call__(self, *args):
            out, n = _sync_checked(lambda: super(CountingMatcher, self).__call__(*args), dev)
            self.syncs += n
            return out

    step = training.make_detr_train_step(tcfg, matcher=CountingMatcher(tcfg.criterion.matcher))
    images, targets = batch(*shape, dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _reset_counts()
    resident = _reset_peak(dev)
    step_syncs = []

    def timed_step():
        loss, n = _sync_checked(lambda: step(state, images, targets)["total"], dev)
        step_syncs.append(n)
        return loss

    ms, losses = _timed_steps(timed_step, n_steps, dev)
    peak = torch.cuda.max_memory_allocated() - resident if dev.type == "cuda" else None
    launches = _launches(dev.type == "cuda")
    report = _train_report("train_detector", model, state, before, ms, losses,
                           step.matcher.syncs, shape[0], peak, resident, launches,
                           dev, training.detr_label)
    if launches["lap_solve"] != n_steps or (dev.type == "cuda" and step.matcher.syncs):
        raise AssertionError(f"train_detector: {launches['lap_solve']} LAP solves and "
                             f"{step.matcher.syncs} synchronizing matcher calls in {n_steps} "
                             "steps (one solve and none a step wanted)")
    report["synchronizing_calls_by_step"] = step_syncs
    report.update(dtype="bfloat16", batch=list(shape), dropout=dcfg.dropout,
                  check={"batch": list(check), "dtype": "float32", "dropout": 0.0,
                         "losses": check_loss, "loss_rel_err_vs_cpu": loss_err,
                         "tol": {"loss_rtol": TRAIN_LOSS_RTOL,
                                 "grad_rtol_card_vs_f64": TRAIN_GRAD_RTOL},
                         "grads": grads},
                  trained_groups={name: len(ps) for name, (_, ps) in state.opt.groups.items()})
    if dev.type == "cuda":
        report["profile"] = train_profile(lambda: step(state, images, targets))
        if any(ca.LAUNCHES.values()):
            raise AssertionError(f"train_detector: attention kernels launched {ca.LAUNCHES}")
    return report, launches


def train_assoc_run(device: str = "cuda", n_steps: int = TRAIN_STEPS["train_assoc"],
                    batch_size: int = 8) -> tuple[dict, dict]:
    """The associator's train step at its default config (256-d, 2 fuser and
    8 GNN layers, 100 Sinkhorn iterations) on train_associator's samples
    (max_tracks 32, max_dets 16, window 50, batch 8): one step on the card
    and on the CPU from the same weights and batch, then ``n_steps`` on one
    fixed batch, and two more profiled."""
    from odam_torch import config as config_mod
    from odam_torch.data import datasets
    from odam_torch.models import associator, training
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.scripts.train_associator import BATCH_KEYS, synthetic_scenes

    dev = torch.device(device)
    cfg = config_mod.merge_cfg([TRAIN_CONFIG])
    acfg = associator.AssociatorConfig.from_cfg(cfg, use_kernels=False)
    rng = np.random.default_rng(0)
    ds = datasets.AssociatorDataset(synthetic_scenes(rng), max_tracks=32, max_dets=16,
                                    window=50)
    b = next(ds.batches(batch_size, rng))
    _reset_counts()
    models, losses = {}, {}
    for side, on in (("cpu", torch.device("cpu")), ("card", dev)):
        model = associator.build_associator(acfg, seed=0, device=on)
        state = training.init_train_state(
            model, training.make_assoc_optimizer(model, training.AssocTrainConfig()))
        step = training.make_assoc_train_step()
        losses[side] = float(step(state, *[torch.from_numpy(b[k]).to(on) for k in BATCH_KEYS]))
        models[side] = model
    cpu_loss, card_loss = losses["cpu"], losses["card"]
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train_assoc: loss card {card_loss} vs CPU {cpu_loss}")
    grads = _grad_errors(models["card"], models["cpu"])
    if grads["max_rel_err"] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"train_assoc: card gradients {grads}")
    del models

    model = associator.build_associator(acfg, seed=0, device=dev)
    state = training.init_train_state(
        model, training.make_assoc_optimizer(model, training.AssocTrainConfig()))
    step = training.make_assoc_train_step()
    args = [torch.from_numpy(b[k]).to(dev) for k in BATCH_KEYS]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _reset_counts()
    resident = _reset_peak(dev)
    step_syncs = []

    def timed_step():
        loss, n = _sync_checked(lambda: step(state, *args), dev)
        step_syncs.append(n)
        return loss

    ms, losses = _timed_steps(timed_step, n_steps, dev)
    peak = torch.cuda.max_memory_allocated() - resident if dev.type == "cuda" else None
    launches = _launches(dev.type == "cuda")
    report = _train_report("train_assoc", model, state, before, ms, losses, sum(step_syncs),
                           batch_size, peak, resident, launches, dev, lambda path: "main")
    report.update(dtype="float32", batch=batch_size, samples=len(ds),
                  check={"dtype": "float32", "loss_cpu": cpu_loss, "loss_card": card_loss,
                         "loss_rel_err": loss_err, "tol": {"loss_rtol": TRAIN_LOSS_RTOL,
                                                           "grad_rtol": TRAIN_GRAD_RTOL},
                         "grads": grads})
    if dev.type == "cuda":
        report["profile"] = train_profile(lambda: step(state, *args))
    return report, launches


def train_cli_run(out_root: str = os.path.join("runs", "train_cli"),
                  device: str = "cuda", extra_det: tuple[str, ...] = (),
                  extra_assoc: tuple[str, ...] = (), config: str = TRAIN_CONFIG,
                  short_side: int = 512) -> tuple[dict, dict]:
    """Both train CLIs as a user runs them (``python -m``, ``--synthetic
    --steps 3``, the scripts' defaults otherwise), then their ``ckpt_3``
    directories through ``run_processor.build_models`` and a 2-frame
    ``run_processor`` run of one committed scene with them (bf16, the
    kernels on; a 16 x 16 mapping capacity, as the run holds one or two
    tracks).  The outputs go under ``runs/`` (gitignored): a full-width
    checkpoint with its optimizer state is about 0.5 GB."""
    import pickle

    from odam_torch import config as config_mod
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.scripts import run_processor
    from odam_torch.utils import checkpoint

    os.makedirs(out_root, exist_ok=True)
    ckpts, seconds, cli_losses = {}, {}, {}
    for name, extra in (("train_detector", extra_det), ("train_associator", extra_assoc)):
        out_dir = os.path.join(out_root, name)
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = [sys.executable, "-m", f"odam_torch.scripts.{name}", "--synthetic",
                "--steps", "3", "--log_every", "1", "--config_path", config,
                "--out_dir", out_dir, "--device", device, *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(argv[1:])} failed:\n{proc.stderr[-3000:]}")
        ckpts[name] = os.path.join(out_dir, "ckpt_3")
        if (checkpoint.load_meta(ckpts[name]) or {}).get("step") != 3:
            raise AssertionError(f"{name}: no complete ckpt_3")
        with open(os.path.join(out_dir, "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        key = "total" if name == "train_detector" else "loss"
        if [r["step"] for r in log] != [1, 2, 3] or not all(np.isfinite(r[key]) for r in log):
            raise AssertionError(f"{name}: log {log}")
        cli_losses[name] = [r[key] for r in log]
    cfg = config_mod.merge_cfg([config])
    detr_m, assoc_m = run_processor.build_models(cfg, ckpts["train_detector"],
                                                 ckpts["train_associator"], "exact",
                                                 torch.device(device))
    del detr_m, assoc_m
    split = os.path.join(out_root, "split.txt")
    with open(split, "w") as f:
        f.write(CLI_FULL_SCENE + "\n")
    argv = ["--config_path", config, "--scans_root", os.path.join(SCENE_DATA, "scans"),
            "--sequences", split, "--detector_ckpt", ckpts["train_detector"],
            "--associator_ckpt", ckpts["train_associator"], "--short_side", str(short_side),
            "--max_frames", "2", "--detect_threshold", "0.0", "--attach_threshold", "0.0",
            "--min_views", "2", "--max_objs", "16", "--max_views", "16",
            "--out_dir", os.path.join(out_root, "run"),
            "--device", device]
    _reset_counts()
    frames, scene_s, run_s = _run_cli(argv)
    counts = _launches(device == "cuda")
    with open(os.path.join(out_root, "run", CLI_FULL_SCENE, CLI_FULL_SCENE), "rb") as f:
        out = pickle.load(f)
    if len(frames) != 2 or not all(np.isfinite(x).all() for x in out["tracks"]):
        raise AssertionError(f"train_cli: run_processor gave {len(frames)} frames, "
                             f"{len(out['tracks'])} tracks")
    report = {"phase": "train_cli", "cli_seconds": seconds, "cli_losses": cli_losses,
              "checkpoints": ckpts, "run_processor_frames": len(frames),
              "run_processor_tracks": len(out["tracks"]), "run_processor_seconds": run_s,
              "launches": counts}
    return report, counts


DIST_SIZE = "full"                 # dryrun_distributed's full-width models
DIST_TIMEOUT_S = 600.0             # a spawned job's ranks in all: a hung collective fails


def _dist_rank(report: dict, on_card: bool) -> dict:
    """One rank's numbers of a dryrun_distributed job."""
    lanes = report["lanes"]
    ar = report["detr_train"].get("allreduce_ms")
    return {"rank": report.get("rank", 0), "seconds": report["seconds"],
            "train_step_ms": {"detr": report["detr_train"]["step_ms"],
                              "assoc": report["assoc_train"]["step_ms"]},
            "grad_allreduce_ms": ar,
            "grad_allreduce_ms_median": None if ar is None else float(np.median(ar)),
            "grad_allreduce_floats": report["detr_train"]["trained_floats"],
            "peak_bytes_by_stage": report["peak_bytes"],
            "lanes_this_rank": lanes["lanes_this_rank"],
            "launches_by_stage": {k: report[k]["launches" if on_card else "plain_calls"]
                                  for k in ("detect", "lanes")},
            "lanes_launches_by_batch": lanes["launches_by_batch"],
            "lane_rate": report.get("lane_rate")}


def dist_runs(out_root: str = os.path.join("runs", "dist"), device: str = "cuda",
              size: str = DIST_SIZE) -> tuple[list[dict], dict]:
    """dist_nccl and dist_gloo2: ``odam_torch.scripts.dryrun_distributed``'s
    six stages (the dp detector and associator train steps, the sharded
    batched detector, the mp solve, the collectives, the scene lanes over
    the ranks) and its lane-rate stage, with ``size``'s full-width models,
    on 1 NCCL rank and on 2 gloo ranks that share the card (NCCL refuses two
    ranks on one card), each rank held to the same stages run here in one
    process without a group (``dryrun_distributed.compare``: losses rtol
    1e-6, gradients within 1e-4 of the largest, parameters after 3 steps
    within 1e-5, lane rows 1e-3, every integer output exact).  Both kernels
    must launch on each rank's lanes, at B = the rank's lanes only (the
    kernels' checks hold them to their plain versions at those shapes).
    Each rank reports its step times, the all-reduce of one detector step's
    gradient timed alone, peak memory and launches by stage: two ranks on
    one card, not a speed-up."""
    from odam_torch.scripts import dryrun_distributed as dry

    on_card = torch.device(device).type == "cuda"
    stages = dry.STAGES + ("lane_rate",)
    _reset_peak(device)
    t0 = time.perf_counter()
    reference = dry.run_stages(size, device, None, stages)
    ref_seconds = time.perf_counter() - t0
    _reset_peak(device)
    reports, paths = [], {}
    for phase, world, backend in (("dist_nccl", 1, "nccl" if on_card else "gloo"),
                                  ("dist_gloo2", 2, "gloo")):
        out_dir = os.path.join(out_root, phase)
        shutil.rmtree(out_dir, ignore_errors=True)
        t0 = time.perf_counter()
        ranks = dry.wait(dry.start(world, backend, device, size, out_dir, stages), out_dir,
                         DIST_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        parity = dry.compare(reference, ranks)
        per_rank = [_dist_rank(rep, on_card) for _, rep in ranks]
        for r, rank in enumerate(per_rank):
            lanes = rank["launches_by_stage"]["lanes"]
            # the tiny CPU rehearsal's images are too small for the flash kernel
            if any(n == 0 for n in (lanes.values() if on_card else [sum(lanes.values())])):
                raise AssertionError(f"{phase} rank {r}: a kernel was never launched on its "
                                     f"lanes: {lanes}")
            batches = {b for by in rank["lanes_launches_by_batch"].values() for b in by}
            if on_card and batches != {str(rank["lanes_this_rank"])}:
                raise AssertionError(f"{phase} rank {r}: launches by batch "
                                     f"{rank['lanes_launches_by_batch']}")
            paths[f"{phase}_rank{r}"] = lanes
        rates = [rank["lane_rate"]["aggregate_frames_per_s"] for rank in per_rank]
        reports.append({
            "phase": phase, "world": world, "backend": backend, "size": size,
            "seconds": seconds, "note": ("one rank through a real process group" if world == 1
                                         else "two ranks sharing one card: not a speed-up"),
            "ranks": per_rank, "parity": parity, "tol": dry.TOL,
            "lane_rate_aggregate_frames_per_s": min(rates),
            "lane_rate_split": f"{world} x {per_rank[0]['lane_rate']['lanes_this_rank']}"})
        shutil.rmtree(out_dir, ignore_errors=True)     # hundreds of MB of npz a rank
    one = _dist_rank(reference[1], on_card)
    reports[0]["one_process"] = {
        "seconds": ref_seconds, "train_step_ms": one["train_step_ms"],
        "peak_bytes_by_stage": one["peak_bytes_by_stage"],
        "launches_by_stage": one["launches_by_stage"],
        "lane_rate_aggregate_frames_per_s":
            reference[1]["lane_rate"]["aggregate_frames_per_s"],
        "lane_rate_split": f"1 x {reference[1]['lane_rate']['lanes']}"}
    return reports, paths


def cli_dist_run(scene_f1: dict, out_root: str = os.path.join("runs", "cli_dist"),
                 device: str = "cuda", n_lanes: int = 4, ranks: int = 2,
                 extra_train: tuple[str, ...] = (), short_side: int = 512) -> dict:
    """Both CLIs on ``ranks`` gloo ranks under ``python -m
    torch.distributed.run``: ``run_processor --scene_parallel 4`` on the hard
    split with the scene phase's flags, then ``eval_scan2cad``, whose F1
    table must equal the scene phase's; then 3 steps of ``train_detector
    --synthetic`` (its defaults: batch 8, 512x672, bf16), whose ``ckpt_3``
    a 2-frame ``run_processor`` reads."""
    import pickle

    from odam_torch.scripts import eval_scan2cad
    from odam_torch.utils import checkpoint

    shutil.rmtree(out_root, ignore_errors=True)
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", str(ranks), "-m"]

    def run(argv, what):
        t0 = time.perf_counter()
        proc = subprocess.run(launch + argv, capture_output=True, text=True,
                              timeout=DIST_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"{what} on {ranks} ranks failed:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        return proc.stdout, time.perf_counter() - t0

    scene_ids, flags = _scene_flags()
    result_dir = os.path.join(out_root, "result")
    stdout, sp_seconds = run(["odam_torch.scripts.run_processor", *flags, "--out_dir",
                              result_dir, "--device", device, "--scene_parallel", str(n_lanes),
                              "--dist_backend", "gloo"], "run_processor")
    f1 = eval_scan2cad.main(["--result_dir", result_dir,
                             "--scan2cad", os.path.join(SCENE_DATA, "full_annotations.json"),
                             "--scans_root", os.path.join(SCENE_DATA, "scans"),
                             "--val_split", os.path.join(SCENE_DATA, "val.txt"),
                             "--min_views", "10"])
    if f1 != scene_f1:
        raise AssertionError(f"cli_dist: F1 {f1['average']} differs from the scene phase's "
                             f"{scene_f1['average']}")
    groups = [line for line in stdout.splitlines() if line.startswith("group of")]
    train_dir = os.path.join(out_root, "train_detector")
    _, train_seconds = run(["odam_torch.scripts.train_detector", "--synthetic", "--steps", "3",
                            "--log_every", "1", "--config_path", TRAIN_CONFIG, "--out_dir",
                            train_dir, "--device", device, "--dist_backend", "gloo",
                            *extra_train], "train_detector")
    ckpt = os.path.join(train_dir, "ckpt_3")
    if (checkpoint.load_meta(ckpt) or {}).get("step") != 3:
        raise AssertionError("cli_dist: train_detector wrote no complete ckpt_3")
    with open(os.path.join(train_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    if [r["step"] for r in log] != [1, 2, 3] or not all(np.isfinite(r["total"]) for r in log):
        raise AssertionError(f"cli_dist: train log {log}")
    split = os.path.join(out_root, "split.txt")
    with open(split, "w") as f:
        f.write(CLI_FULL_SCENE + "\n")
    run_dir = os.path.join(out_root, "run")
    frames, _, run_s = _run_cli([
        "--config_path", TRAIN_CONFIG, "--scans_root", os.path.join(SCENE_DATA, "scans"),
        "--sequences", split, "--detector_ckpt", ckpt, "--associator_ckpt", "",
        "--short_side", str(short_side), "--max_frames", "2", "--detect_threshold", "0.0",
        "--attach_threshold", "0.0", "--min_views", "2", "--max_objs", "16",
        "--max_views", "16", "--out_dir", run_dir, "--device", device])
    with open(os.path.join(run_dir, CLI_FULL_SCENE, CLI_FULL_SCENE), "rb") as f:
        out = pickle.load(f)
    if len(frames) != 2 or not all(np.isfinite(x).all() for x in out["tracks"]):
        raise AssertionError(f"cli_dist: run_processor gave {len(frames)} frames")
    return {"phase": "cli_dist", "ranks": ranks, "backend": "gloo",
            "note": "ranks sharing one card: not a speed-up",
            "run_processor_seconds": sp_seconds, "groups": groups, "f1": f1["average"],
            "f1_equals_scene": True, "train_detector_seconds": train_seconds,
            "train_losses": [r["total"] for r in log],
            "train_imgs_per_sec": [r["imgs_per_sec"] for r in log],
            "checkpoint_read_frames": len(frames), "checkpoint_read_seconds": run_s,
            "checkpoint_read_tracks": len(out["tracks"])}


# ------------------------------------------------- tracking and evaluation

TRACK_CONFIG = os.path.join("configs", "detr_scan_net.yaml")
TRACK_REHEARSAL_FRAMES = 8         # tracking_rehearsal: frames of CLI_FULL_SCENE
ASSOC_SEED = 4                     # the synthetic ground-truth tracks of eval_association
ASSOC_SCENES = {"n_scenes": 2, "n_tracks": 6, "n_frames": 40}
MAP_TOOLS_CHECK_ITERS = 5          # card vs CPU: the Adam solve is chaotic over 200
MAP_TOOLS_MIN_VIEWS = "2"          # 8 frames of tracks: solve every track seen twice


def tracking_run(out_root: str = os.path.join("chiprun_out", "tracking"), device: str = "cuda",
                 max_frames: int | None = None) -> tuple[dict, dict]:
    """``python -m odam_torch.scripts.run_tracking`` at full width: the
    seeded ResNet-50 DETR of configs/detr_scan_net.yaml (hidden 256, 6+6
    layers, 100 queries) in bf16, the CLI's default, on the committed hard
    split (3 scenes x 32 frames resized to 800x800: 625 image tokens), then
    the heuristic tracker on the host.  Thresholds 0, so that the seeded
    detector's detections reach the tracker.  Per scene: frames/s, the
    median frame (read and resize, detection to one host copy, tracker
    step) and each stage's mean, host copies a frame, and the launches by
    kernel and dtype: flash 12 (6 encoder self, 6 decoder cross) and fused
    6 (decoder self) a frame, all bf16."""
    import pickle

    from odam_torch.ops import cuda_attention as ca
    from odam_torch.scripts import run_tracking

    dev = torch.device(device)
    scenes = []
    inner = run_tracking.track_scene

    def recorded(detr, index, seq_id, args):
        t0 = time.perf_counter()
        (tracks, stats), calls, by_dtype = _counted(dev, inner, detr, index, seq_id, args)
        seconds = time.perf_counter() - t0
        n = len(stats["frame_ms"])
        scenes.append({"scene": seq_id, "frames": n, "seconds": seconds,
                       "frames_per_s": n / seconds,
                       "median_frame_ms": float(np.median(stats["frame_ms"])),
                       "stage_mean_ms": {k: v["mean_ms"] for k, v in stats["stages"].items()},
                       "host_syncs_per_frame": stats["host_copies"] / n, "tracks": len(tracks),
                       "launches": calls, "launches_by_dtype": by_dtype})
        return tracks, stats

    argv = ["--config_path", TRACK_CONFIG, "--scans_root", os.path.join(SCENE_DATA, "scans"),
            "--sequences", os.path.join(SCENE_DATA, "val.txt"), "--detector_ckpt", "",
            "--detect_threshold", "0.0", "--track_threshold", "0.0", "--out_dir", out_root,
            "--device", device] + (["--max_frames", str(max_frames)] if max_frames else [])
    _reset_counts()
    run_tracking.track_scene = recorded
    try:
        t0 = time.perf_counter()
        if run_tracking.main(argv) != 0:
            raise AssertionError("run_tracking failed")
        seconds = time.perf_counter() - t0
    finally:
        run_tracking.track_scene = inner
    launched = _launches(dev.type == "cuda")
    for s in scenes:
        want = {"flash_attention": 12 * s["frames"], "fused_attention": 6 * s["frames"],
                "lap_solve": 0}
        if s["launches"] != want:
            raise AssertionError(f"tracking {s['scene']}: launches {s['launches']}, expected {want}")
        _check_dtype(f"tracking {s['scene']}", s["launches_by_dtype"], "bfloat16")
        if s["host_syncs_per_frame"] != 1.0:
            raise AssertionError(f"tracking {s['scene']}: {s['host_syncs_per_frame']} host "
                                 "copies a frame")
        with open(os.path.join(out_root, s["scene"], s["scene"]), "rb") as f:
            tracks = pickle.load(f)["tracks"]
        if not tracks or not all(t.shape[1] == 14 and np.isfinite(t).all() for t in tracks):
            raise AssertionError(f"tracking {s['scene']}: {len(tracks)} tracks, or bad rows")
    if len(scenes) != 3:
        raise AssertionError(f"tracking: {len(scenes)} scenes")
    return ({"phase": "tracking", "config": TRACK_CONFIG, "dtype": "bfloat16",
             "weights": "seeded", "size": "800x800", "seconds": seconds, "scenes": scenes,
             "launches": launched}, launched)


def tracking_rehearsal_run(out_root: str = os.path.join("chiprun_out", "tracking_rehearsal"),
                           devices: tuple[str, str] = ("cuda", "cpu"),
                           n_frames: int = TRACK_REHEARSAL_FRAMES) -> tuple[dict, dict, str]:
    """``run_tracking.track_scene`` with the committed rehearsal detector
    (TinyBackbone stage 3, hidden 64, 4 heads, 16 queries) in f32 on the
    first ``n_frames`` frames of CLI_FULL_SCENE at 800x800 (2500 image
    tokens: flash 4 and fused 2 a frame), on the card and on the CPU: the
    same tracks, frame and class exact, the rest within the DETR card-vs-CPU
    bar (atol = rtol = 1e-3).  Writes the card's tracks as run_tracking
    does, for mapping_tools.  Returns (report, the card's launches, the
    tracks pickle)."""
    import pickle

    from odam_torch import config as config_mod
    from odam_torch.data import scannet
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.scripts import run_processor, run_tracking

    args = run_tracking.build_parser().parse_args(
        ["--scans_root", os.path.join(SCENE_DATA, "scans"), "--max_frames", str(n_frames)])
    cfg = config_mod.merge_cfg([os.path.join(SCENE_DATA, "rehearsal.yaml")])
    index = scannet.SceneIndex(args.scans_root, [CLI_FULL_SCENE])
    runs = {}
    _reset_counts()
    for side, device in zip(("card", "cpu"), devices):
        dev = torch.device(device)
        det, _ = run_processor.build_models(
            cfg, os.path.join("artifacts", "torch", "rehearsal_hard_detr.npz"), None, "exact",
            dev, torch.float32)
        t0 = time.perf_counter()
        (tracks, stats), calls, by_dtype = _counted(dev, run_tracking.track_scene, det, index,
                                                    CLI_FULL_SCENE, args)
        runs[side] = {"tracks": tracks, "stats": stats, "calls": calls, "by_dtype": by_dtype,
                      "seconds": time.perf_counter() - t0}
        del det
    card, cpu = runs["card"], runs["cpu"]
    frames = len(card["stats"]["frame_ms"])
    want = {"flash_attention": 4 * frames, "fused_attention": 2 * frames, "lap_solve": 0}
    for side, run in runs.items():
        if run["calls"] != want:
            raise AssertionError(f"tracking_rehearsal {side}: attention calls {run['calls']}, "
                                 f"expected {want}")
        _check_dtype(f"tracking_rehearsal {side}", run["by_dtype"], "float32")
    if len(card["tracks"]) != len(cpu["tracks"]) or not card["tracks"]:
        raise AssertionError(f"tracking_rehearsal: {len(card['tracks'])} tracks on the card, "
                             f"{len(cpu['tracks'])} on the CPU")
    box_px, other = 0.0, 0.0
    for a, b in zip(card["tracks"], cpu["tracks"]):
        if a.shape != b.shape or not np.array_equal(a[:, :2], b[:, :2]):
            raise AssertionError("tracking_rehearsal: track frame ids or classes differ")
        if not np.allclose(a, b, atol=DETR_ATOL, rtol=DETR_RTOL):
            raise AssertionError(f"tracking_rehearsal: rows card vs CPU beyond atol = rtol = "
                                 f"{DETR_ATOL}: {np.abs(a - b).max(axis=0)}")
        box_px = max(box_px, float(np.abs(a[:, 2:6] - b[:, 2:6]).max()))
        other = max(other, float(np.abs(a[:, 6:] - b[:, 6:]).max()))
    path = os.path.join(out_root, CLI_FULL_SCENE, CLI_FULL_SCENE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"tracks": card["tracks"]}, f)
    report = {"phase": "tracking_rehearsal", "scene": CLI_FULL_SCENE, "frames": frames,
              "size": "x".join(map(str, card["stats"]["size"])), "tracks": len(card["tracks"]),
              "max_box_abs_diff_px": box_px, "max_other_abs_diff": other,
              "median_frame_ms": {d: float(np.median(r["stats"]["frame_ms"]))
                                  for d, r in runs.items()},
              "stage_mean_ms": {d: {k: v["mean_ms"] for k, v in r["stats"]["stages"].items()}
                                for d, r in runs.items()},
              "seconds": {d: r["seconds"] for d, r in runs.items()},
              "launches": card["calls"], "cpu_plain_calls": cpu["calls"]}
    return report, card["calls"], path


def eval_association_run(out_root: str = os.path.join("chiprun_out", "eval_association"),
                         devices: tuple[str, str] = ("cuda", "cpu")) -> tuple[dict, dict]:
    """``python -m odam_torch.scripts.eval_association`` on 2 synthetic
    scenes x 6 ground-truth tracks x 40 frames (train_associator's
    generator, seeded): first the full-width associator (configs/
    detr_scan_net.yaml: 256-d, 4 heads, 2 fuser and 8 GNN layers, 100
    Sinkhorn iterations) with seeded weights saved as .npz, on the card:
    ms a frame and the launches, fused 16 a frame (8 GNN layers x 2
    directions at batch 1; the fuser at batch 64 is plain); then the
    committed rehearsal associator on the card and on the CPU: per-frame
    counts and P / R / F1 equal."""
    import pickle

    from odam_torch import config as config_mod
    from odam_torch.eval import association
    from odam_torch.models import associator, convert
    from odam_torch.ops import cuda_attention as ca
    from odam_torch.scripts import eval_association
    from odam_torch.scripts.train_associator import synthetic_scenes

    tracks_dir = os.path.join(out_root, "tracks")
    os.makedirs(tracks_dir, exist_ok=True)
    for name, tracks in synthetic_scenes(np.random.default_rng(ASSOC_SEED),
                                         **ASSOC_SCENES).items():
        with open(os.path.join(tracks_dir, name), "wb") as f:
            pickle.dump({"tracks": tracks}, f)
    seeded = os.path.join(out_root, "seeded_assoc.npz")
    model = associator.build_associator(
        associator.AssociatorConfig.from_cfg(config_mod.merge_cfg([TRACK_CONFIG])), seed=0,
        device="cpu")
    convert.save_flax_npz(seeded, convert.state_dict_to_flax(model))
    del model

    card, cpu = (torch.device(d) for d in devices)
    scene_s = []
    inner = association.evaluate_scene

    def timed(*a, **k):
        t0 = time.perf_counter()
        m = inner(*a, **k)
        scene_s.append(time.perf_counter() - t0)        # ends in host copies: synchronised
        return m

    association.evaluate_scene = timed
    try:
        _reset_counts()
        full, calls, by_dtype = _counted(card, eval_association.main, [
            "--config_path", TRACK_CONFIG, "--tracks_dir", tracks_dir, "--ckpt", seeded,
            "--device", devices[0]])
    finally:
        association.evaluate_scene = inner
    frames = full["TOTAL"].n_frames
    if calls != {"flash_attention": 0, "fused_attention": 16 * frames, "lap_solve": frames}:
        raise AssertionError(f"eval_association: launches {calls} over {frames} frames")
    _check_dtype("eval_association", by_dtype, "float32")
    rehearsal = ["--config_path", os.path.join(SCENE_DATA, "rehearsal.yaml"),
                 "--tracks_dir", tracks_dir,
                 "--ckpt", os.path.join("artifacts", "torch", "rehearsal_hard_assoc.npz")]
    got, rehearsal_calls, _ = _counted(card, eval_association.main,
                                       rehearsal + ["--device", devices[0]])
    want = eval_association.main(rehearsal + ["--device", devices[1]])
    for name, w in want.items():
        g = got[name]
        if g.per_frame != w.per_frame or (g.precision, g.recall, g.f1) != (
                w.precision, w.recall, w.f1):
            raise AssertionError(f"eval_association {name}: card P/R/F1 "
                                 f"{(g.precision, g.recall, g.f1)} differ from the CPU's "
                                 f"{(w.precision, w.recall, w.f1)}")
    if rehearsal_calls["fused_attention"] == 0:
        raise AssertionError("eval_association: the rehearsal associator launched no kernel")
    return ({"phase": "eval_association", "scenes": ASSOC_SCENES, "frames": frames,
             "full_width_ms_per_frame": 1e3 * sum(scene_s) / frames,
             "full_width_f1": full["TOTAL"].f1, "launches": calls,
             "rehearsal": {n: {"p": m.precision, "r": m.recall, "f1": m.f1,
                               "frames": m.n_frames} for n, m in got.items()},
             "rehearsal_card_equals_cpu": True, "rehearsal_launches": rehearsal_calls},
            calls)


def mapping_tools_run(tracks_pickle: str,
                      out_root: str = os.path.join("chiprun_out", "mapping_tools"),
                      devices: tuple[str, str] = ("cuda", "cpu"), n_iters: int = 200) -> dict:
    """``run_multi_view`` (``n_iters`` Adam iterations) then ``run_merge`` on the
    tracks of tracking_rehearsal, on the card: the solve's seconds, the
    object and merged counts.  Then ``--n_iters 5`` on the card and on the
    CPU: ``bboxes_dl`` within 1e-3 and ``bboxes_qc`` at oriented IoU >= 0.95
    (SCENE_QC_IOU), and the merged tracks equal."""
    from odam_torch.scripts import run_merge, run_multi_view
    from odam_torch.utils.host_boxes import robust_box3d_iou

    os.makedirs(out_root, exist_ok=True)
    common = ["--tracks", tracks_pickle, "--scans_root", os.path.join(SCENE_DATA, "scans"),
              "--scene", CLI_FULL_SCENE, "--min_views", MAP_TOOLS_MIN_VIEWS]

    def solve(device, tag, extra=()):
        out = os.path.join(out_root, f"{tag}.pkl")
        res = run_multi_view.main(common + ["--out", out, "--device", device, *extra])
        return res, run_merge.main(["--input", out, "--out", os.path.join(out_root,
                                                                          f"{tag}_merged.pkl")])

    full, merged = solve(devices[0], f"card{n_iters}", ("--n_iters", str(n_iters)))
    if not all(np.isfinite(b).all() for b in (*full["bboxes_qc"], *full["bboxes_dl"])):
        raise AssertionError("mapping_tools: non-finite boxes")
    check = ("--n_iters", str(MAP_TOOLS_CHECK_ITERS))
    (card, card_merged), (cpu, cpu_merged) = (solve(d, f"{side}{MAP_TOOLS_CHECK_ITERS}", check)
                                              for side, d in zip(("card", "cpu"), devices))
    dl = max(float(np.abs(a - b).max()) for a, b in zip(card["bboxes_dl"], cpu["bboxes_dl"]))
    ious = [robust_box3d_iou(a, b) for a, b in zip(card["bboxes_qc"], cpu["bboxes_qc"])]
    if not dl <= 1e-3 or min(ious) < SCENE_QC_IOU:
        raise AssertionError(f"mapping_tools: card vs CPU bboxes_dl {dl:.3e}, "
                             f"bboxes_qc IoU {min(ious):.4f}")
    if len(card_merged) != len(cpu_merged) or not all(
            np.array_equal(a, b) for a, b in zip(card_merged, cpu_merged)):
        raise AssertionError("mapping_tools: merged tracks card vs CPU differ")
    return {"phase": "mapping_tools", "objects": len(full["bboxes_qc"]),
            "solve_seconds": full["seconds"], "iterations": n_iters, "merged": len(merged),
            "check_iterations": MAP_TOOLS_CHECK_ITERS,
            "check_seconds": {"card": card["seconds"], "cpu": cpu["seconds"]},
            "max_bboxes_dl_abs_diff": dl, "min_qc_iou_card_vs_cpu": min(ious),
            "merged_card_equals_cpu": True}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two steps with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import odam_torch  # noqa: F401  (fails here when run outside the repo)

    # f32 comparisons need full f32: cuDNN convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    emit(toolchain())
    emit(build())
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    kernel_rows = kernel_checks(gen)
    emit({"phase": "kernel_checks", "cases": len(kernel_rows), "all_within_tolerance": True})
    lap_report, lap_rows = lap_checks()
    emit(lap_report)
    kernel_rows += lap_rows
    modules, det_gpu, as_gpu = module_checks(rng)
    emit(modules)
    paths = {}
    variants_report, paths["detr_variants"] = detr_variants_run()
    emit(variants_report)
    frames = _slice_frames(rng)
    slice_report, paths["slice"], slice_pipe = slice_run(det_gpu, as_gpu, frames,
                                                         profile=args.profile)
    emit(slice_report)
    bf16_report, paths["slice_bf16"] = slice_bf16_run(frames, slice_pipe, slice_report,
                                                      profile=args.profile)
    emit(bf16_report)
    offline_report, paths["offline"] = offline_run(det_gpu, as_gpu, frames, slice_pipe)
    emit(offline_report)
    del slice_pipe
    sp_full_report, sp_counts = scene_parallel_full_run(det_gpu, as_gpu)
    emit(sp_full_report)
    paths["scene_parallel_full"] = sp_counts["float32"]
    paths["scene_parallel_full_bf16"] = sp_counts["bfloat16"]
    for path in ("slice", "slice_bf16"):
        for name, n in paths[path].items():
            if n == 0:
                raise AssertionError(f"{name} was never launched on the {path} path")
    mapping_report = mapping_run(np.random.default_rng(MAP_SEED), det_gpu, as_gpu)
    emit(mapping_report)
    emit(mapping_lm_run(det_gpu, as_gpu, mapping_report))
    del det_gpu, as_gpu
    scene_report, paths["scene"] = scene_run()
    emit(scene_report)
    if paths["scene"]["fused_attention"] == 0:
        raise AssertionError("fused_attention was never launched on the scene path")
    sp_hard_report, paths["scene_parallel_hard"] = scene_parallel_hard_run(scene_report["f1"])
    emit(sp_hard_report)
    cli_sp_report, paths["cli_scene_parallel"] = cli_scene_parallel_run(scene_report["f1"])
    emit(cli_sp_report)
    cli_runs = {"cli_full": ("--dtype", "float32"),
                "cli_fast": ("--profile", "fast", "--device_resize", "--dtype", "bfloat16"),
                "cli_offline": ("--offline", "--detect_batch", "4", "--solver", "lm")}
    for phase, extra in cli_runs.items():
        report, paths[phase] = cli_full_run(out_root=os.path.join("chiprun_out", phase),
                                            extra=extra, phase=phase)
        emit(report)
    for path in ("cli_full", "cli_fast"):
        for name in ("flash_attention", "fused_attention"):
            if paths[path][name] == 0:
                raise AssertionError(f"{name} was never launched on the {path} path")
    if paths["cli_offline"]["fused_attention"] == 0:
        raise AssertionError("fused_attention was never launched on the cli_offline path")
    for run in (train_detector_run, train_assoc_run, train_cli_run):
        report, counts = run()
        paths[report["phase"]] = counts
        emit(report)
    dist_reports, dist_paths = dist_runs()
    for report in dist_reports:
        emit(report)
    paths.update(dist_paths)
    emit(cli_dist_run(scene_report["f1"]))
    tracking_report, paths["tracking"] = tracking_run()
    emit(tracking_report)
    rehearsal_report, paths["tracking_rehearsal"], tracks_pickle = tracking_rehearsal_run()
    emit(rehearsal_report)
    assoc_report, paths["eval_association"] = eval_association_run()
    emit(assoc_report)
    for path in ("tracking", "tracking_rehearsal"):      # the host tracker solves no LAP
        for name in ("flash_attention", "fused_attention"):
            if paths[path][name] == 0:
                raise AssertionError(f"{name} was never launched on the {path} path")
    if paths["eval_association"]["fused_attention"] == 0:
        raise AssertionError("fused_attention was never launched on the eval_association path")
    emit(mapping_tools_run(tracks_pickle))
    for path in ("offline", "scene_parallel_full", "scene_parallel_full_bf16", "scene",
                 "scene_parallel_hard", "cli_scene_parallel", "cli_full", "cli_offline",
                 "train_detector", "eval_association"):     # cli_fast decodes greedily
        if not paths[path].get("lap_solve"):
            raise AssertionError(f"lap_solve was never launched on the {path} path")
    for row in kernel_rows:
        if row["path"] == "lanes":      # the lane step's launches at this B
            row["launches"] = sp_full_report["launches_by_batch"][row["dtype"]][row["name"]].get(
                row["shape"]["B"], 0)
        else:
            main_path = "slice" if row["dtype"] == "float32" else "slice_bf16"
            row["launches"] = paths[main_path][row["name"]]
        row["launches_by_path"] = {path: counts.get(row["name"])
                                   for path, counts in paths.items()}
    emit({"kernels": kernel_rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
