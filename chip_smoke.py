#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card (an H100 for this repo).

    python3 chip_smoke.py              # the whole check; exits 0 only if all holds
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown of two steps

Phases, each printed as one JSON line on stdout:

1. toolchain: torch, CUDA, nvcc and Triton versions, the card's name and
   power limit;
2. build: nvcc builds every CUDA library of the kernel seam
   (odam_torch/ops/kernels.py: attention, LAP, Sinkhorn, MSDA) from
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
   plain path (so their times show what that routing costs), and
   ``bench_attention``'s shapes (fused at 400 and 1050 keys, in 256-key
   slabs; flash at all three);
   lap: the LAP kernel (odam_torch/csrc/lap.cu) against its plain version,
   the host solver, at the decode's shapes (B = 1 and 8), the matcher's 48
   problems, tie-heavy integer costs, all-masked problems, 256 x 256, each
   K of the registers route (32, 33, 129 columns), the largest problem it
   stages whole (227 x 256) and the shared route (257 columns):
   assignments equal in every problem, total cost equal to scipy's, each
   case on the route lap.plan names, device time from a CUDA graph beside
   the shared route's kernel at the same case and the host path's (copy +
   host solve), the plain solver's sweeps and ns a sweep;
   msda_checks: the MSDA kernel (odam_torch/csrc/msda.cu) against its plain
   version at the deformable benchmark cell's shapes (B = 16 over its four
   levels; the encoder, every token a query, and the decoder's
   cross-attention, 300 queries; f32 and bf16 values): within
   ``msda_bar``, which the plain version with bf16 locations must fail;
   device time from a CUDA graph, the plain version's, the bound;
   sinkhorn_checks: the Sinkhorn kernel (odam_torch/csrc/sinkhorn.cu)
   against its plain version at the lane step's [16, 64, 30], on seeded
   stores and on lanes with an empty store, no detections or both, at 0,
   1, 3 and 100 iterations: one launch a call, live entries within 1e-5,
   the -inf and NaN entries exactly; device time from a CUDA graph, the
   plain version's, the issue times, the bound;
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
   and 8 lanes of 4 uint8 frames each (every lane in its own order), f32
   then bf16, every lane against the serial f32 pipeline; aggregate
   frames/s, step and lane-frame times, launches a step (profiled), host
   syncs (none from step 2 on), one LAP and one Sinkhorn launch a step,
   peak memory, and both kernels' launches at B = P;
   deformable_lanes: Deformable DETR (odam_torch/configs/
   deformable_detr_scan_net.yaml, seeded) through SceneParallelRunner at 16
   lanes of 4 frames, f32 with the kernels, f32 on the plain route, bf16:
   the MSDA counters zeroed before each run, 12 calls a step (launches of
   the run's dtype, or plain calls), the samples they took, one LAP and
   one Sinkhorn launch a step, flash and fused launched; the f32 kernel
   run's lanes equal to the plain run's (detections and ids exact, rows
   within 1e-3).  No other
   path launches the MSDA kernel (every path's launch counts hold it);
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
    the committed weights (artifacts/torch/*.npz), on the card, then on the
    CPU (three processes at once, a scene each): the same tracks, boxes and
    F1 table, and the kernel launches of every frame checked;
12. scene_parallel_hard: SceneParallelRunner on the same three scenes
    (their first 16 frames) at P = 3 and P = 4 (one lane of padding)
    against the serial OdamPipeline on the card: tracks with frame ids and
    classes exact, rows within 1e-3, the serial run's F1 table,
    fused_attention launched at B = P;
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
    matcher, frozen leaves bit-equal, no attention kernel and no Sinkhorn
    kernel launched, and a profile of two steps (host- or device-bound);
15. train_assoc: the same for the associator at its defaults (20 steps,
    batch 8, no host sync), Sinkhorn on its plain version (``use_kernels=False``);
16. train_cli: ``python -m odam_torch.scripts.train_{detector,associator}
    --synthetic --steps 3`` on the card, their checkpoints through
    ``run_processor.build_models`` and a 2-frame ``run_processor`` run;
    ``train_detector --resume_ckpt`` from its step-2 checkpoint in a fresh
    process: the step-3 loss within 1e-3 of the uninterrupted run's;
17. dist_nccl, dist_gloo2: ``odam_torch.scripts.dryrun_distributed``'s six
    stages at full width on 1 NCCL rank and on 2 gloo ranks sharing the
    card, each rank held to the same stages in one process, with step
    times, the gradient all-reduce, peak memory, launches by stage and the
    lanes' aggregate frames/s at P = 8 (1 x 8 here, 2 x 4 over the ranks);
18. cli_dist: ``run_processor --scene_parallel 4`` on the hard split's
    first scene and ``train_detector`` on 2 gloo ranks under ``python -m
    torch.distributed.run``: the scene phase's F1 table on that scene, and
    the checkpoint read by ``run_processor``;
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
    within 1e-3, bboxes_qc IoU >= 0.95, merged tracks equal);
22. tools: the eight tooling scripts of ``odam_torch/scripts`` (the
    attention bench, the pipeline and batched-detector profiles, the
    transport A/B, the lanes and batched-detection benches, the LM envelope
    sweep, the crash-recovery demo) in-process through ``main(argv)`` at
    cut depths (``TOOL_ARGS``), each tool's launches by kernel and dtype
    counted; the kernel errors, fused at 1050 and 400 keys, every MFU below
    100%, prefix times rising with the stage, equal track ids across the
    transports, kernel events in the trace, the sweep's card rows against
    the CPU's and the crash demo's resumed loss all checked;
23. examples: the example scripts of ``odam_torch/examples`` in-process
    (``EXAMPLE_DEPTH``): ``synthetic_mapping`` at full depth (loss falls more
    than 10x, mean IoU above 0.7, the chair's fragments fuse);
    ``fit_superquadric``'s ``fit`` at 2000 iterations (final L1 below 1e-2);
    ``train_associator_synthetic`` at 400 steps, F1 before and after on the
    card and the CPU (before equal, after within 0.05, after above before),
    the LAP launched by its evaluation; the closed loop: ``segment_train``
    for 50 steps, resumed for 50 more, then ``segment_eval``, fused_attention
    launched; ``make_dataset --hard`` into ``chiprun_out/``; the rehearsal
    trainer in each mode for 20 steps at batch 8; ``probe_detector`` on the
    committed weights, card counts equal to the CPU's, fused_attention
    launched.  Each script's launches by kernel and dtype are counted;
24. studies: the rehearsal studies of ``odam_torch/examples/cli_rehearsal``
    and the artifact tools, each on the card through its own main or
    public functions: ``ci_eval``, ``tune_min_views`` and ``audit_misses``
    score the scene phase's card and CPU results (counts, F1, modes equal;
    F1 the scene phase's); on a one-scene, 16-frame hard split,
    ``tune_threshold`` runs the reference's operating point (0.6 / 0.8),
    which is ablate's baseline cell, and ``ablate.run_config`` the
    ``stale_track_bbox`` fault (its track rows must differ: the variable
    reached the child), ``ablate_big.score`` pairs the two cells, and the
    fault's F1 at min_views 6 must fall below the baseline's;
    ``window_experiment`` fine-tunes the committed associator at window 400
    for 3 steps and runs that arm (F1 above 0 at min_views 6);
    ``diagnose_recall``'s three stages on one seed, its oracle_det tracking
    against the CPU's, fused_attention and lap_solve launched in-process;
    ``validate`` on the committed weights,
    card against CPU; ``retrain.sh`` as far as its segment logic.  The
    spawning scripts run in threads beside the in-process work; their
    child processes' launches are not counted.

Then the kernel table (the LAP and Sinkhorn kernels' rows too) with the
launch counts of every path (each row's time above its bound; every path
that associates on the card has launched the Sinkhorn kernel, and no
training path has), the card's name and power limit as nvidia-smi prints them,
and as the last line {"ok": true, "device": {...}}.  It imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
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
    from odam_torch.ops.kernels import nvcc_path

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
    from odam_torch.ops.kernels import nvcc_path

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
    """Every CUDA library of the kernel seam, one nvcc each, started
    together; ptxas' registers and spills, and the HMMA instructions of
    each attention kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from odam_torch.ops import kernels

    cuda = [lib for lib in kernels.LIBRARIES.values() if lib.compiler == "nvcc"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda)) as pool:
        for job in [pool.submit(lib.load) for lib in cuda]:
            job.result()
    seconds = time.perf_counter() - t0
    libs = {}
    for lib in cuda:
        info = lib.info
        libs[lib.name] = {"seconds": info["seconds"] if not info["cached"] else "cached",
                          "library": os.path.relpath(info["path"]),
                          "ptxas": [ln.strip() for ln in info.get("ptxas", "").splitlines()
                                    if "registers" in ln or "spill" in ln or "smem" in ln]}
    hmma = hmma_counts(kernels.ATTENTION.info["path"])
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
    # the examples phase: the closed loop's DETR (hidden 64 over 4 heads, 12
    # queries, 128x128 frames: 16 image tokens, no padded pixel) and the GNN
    # of train_associator_synthetic's evaluation (8 track slots, 5 tracks a
    # scene, 6 detection slots; dh 16)
    _case("fused_attention", 1, 16, 16, 4, 16, torch.float32,
          label="closed loop: encoder self", path="examples:closed_loop_eval"),
    _case("fused_attention", 1, 12, 16, 4, 16, torch.float32,
          label="closed loop: decoder cross", path="examples:closed_loop_eval"),
    _case("fused_attention", 1, 12, 12, 4, 16, torch.float32, mask=False,
          label="closed loop: decoder self", path="examples:closed_loop_eval"),
    *[_case("fused_attention", 1, Lq, Lk, 4, 16, torch.float32, masked_tail=tail,
            mask=tail > 0, label=f"associator eval: GNN {label}",
            path="examples:train_associator_synthetic")
      for label, Lq, Lk, tail in (("track self", 8, 8, 3), ("detection self", 6, 6, 0),
                                  ("track<-detection cross", 8, 6, 0),
                                  ("detection<-track cross", 6, 8, 3))],
    # bench_attention's shapes (odam_torch/scripts/bench_attention.py: CASES,
    # 7 padded keys at the tail): fused at 1050 and 400 keys, past one
    # 256-key slab, and flash at all three
    *[_case(name, B, Lq, Lk, H, dh, dtype, masked_tail=7, label=f"bench_attention: {case}",
            path="bench_attention")
      for dtype in (torch.float32, torch.bfloat16)
      for case, B, Lq, Lk, H, dh in (("encoder_1050tok", 1, 1050, 1050, 8, 32),
                                     ("fuser_w100_48trk", 48, 100, 100, 4, 64),
                                     ("fuser_w400_48trk", 48, 400, 400, 4, 64))
      for name in ("fused_attention", "flash_attention")
      if name == "flash_attention" or Lk >= 256],
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


def lap_checks() -> tuple[dict, list[dict]]:
    """The LAP kernel against its plain version (the host solver) on the
    same inputs (``profile_lap.lap_cases``: the main paths' problems, the
    edges, each K of the registers route and the shared route): assignments
    equal in every problem, total cost equal to scipy's, each case counted
    under the route ``lap.plan`` names; the kernel's device time from a CUDA
    graph, beside the shared route's kernel at the same case (the first
    kernel, its own yardstick), the host path's (the copy to the host and
    the plain solve), the plain solver's sweeps and ns a sweep; and the
    decode and the matcher whole on the card against the CPU."""
    from scipy.optimize import linear_sum_assignment

    from odam_torch.ops import kernels, lap
    from odam_torch.scripts.profile_lap import lap_cases, launcher, plain_stats

    rng = np.random.default_rng(LAP_SEED)
    rows = []
    for label, cost in lap_cases(rng, ASSOC_MATCH_THRESHOLD):
        S, R, C = cost.shape
        plan = lap.plan(R, C)
        gpu = cost.cuda()
        routes = kernels.counts("ROUTE_LAUNCHES")["lap_solve"]
        got = lap.solve(gpu)
        torch.cuda.synchronize()
        if kernels.counts("ROUTE_LAUNCHES")["lap_solve"][plan.route] != routes[plan.route] + 1:
            raise AssertionError(f"lap_solve {label}: not launched on the {plan.route} route")
        want, stats = plain_stats(cost)
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

        shared_out = torch.empty_like(got)      # the shared route's kernel, outside the counts
        shared_route = launcher(kernels.LAP, "shared", gpu, shared_out)
        shared_route()
        torch.cuda.synchronize()
        if not torch.equal(shared_out.cpu(), want):
            raise AssertionError(f"lap_solve {label}: the shared route differs from the plain "
                                 "solver")
        host_ms = sorted(host_path() for _ in range(5))[2]
        n_bytes = 4 * S * R * C + 4 * S * R
        rows.append({
            "name": "lap_solve", "route": "cuda", "source": LAP_SOURCE,
            "replaces": LAP_REPLACES, "case": label, "shape": {"S": S, "R": R, "C": C},
            "lap_route": plan.route, "K": plan.K, "staged_rows": plan.staged_rows,
            "dtype": "float32", "path": "lap", "launches": None,
            "max_abs_err": 0.0, "tol": "assignments equal to the plain solver's; total cost "
                                       "within 1e-5 x max(1, |cost|) of scipy's",
            "total_cost_gap_scipy": gap,
            "ms": graph_ms(lambda: lap.solve(gpu)), "issue_ms": cuda_ms(lambda: lap.solve(gpu)),
            "shared_route_ms": graph_ms(shared_route),
            "plain_ms": host_ms, "plain_is": "copy to the host + the plain solver (median of 5)",
            "library_ms": None,
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "sweeps": stats["sweeps"], "augment_steps": stats["augment_steps"],
            "bound_note": "bytes over 3.35 TB/s; the kernel is latency-bound: the chain of "
                          "dependent Dijkstra sweeps of its slowest problem (sweeps, "
                          "augment_steps: the plain solver's on this input)",
            "mbytes": n_bytes / 1e6,
        })
        rows[-1]["ns_per_sweep"] = rows[-1]["ms"] * 1e6 / stats["sweeps"]
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
              "shared_route_ms": {r["case"]: r["shared_route_ms"] for r in rows},
              "ns_per_sweep": {r["case"]: r["ns_per_sweep"] for r in rows},
              "routes": {r["case"]: [r["lap_route"], r["K"]] for r in rows},
              "host_path_ms": {r["case"]: r["plain_ms"] for r in rows}}
    return report, rows


# --------------------------------------------------------------------- msda

MSDA_SOURCE = "odam_torch/csrc/msda.cu"
# the deformable cell's levels at 800x1071: C3, C4, C5 and the stride-2 conv on C5
MSDA_LEVELS = ((100, 134), (50, 67), (25, 34), (13, 17))
MSDA_HEADS, MSDA_DH, MSDA_POINTS = 8, 32, 4
MSDA_CASES = {"encoder": None, "decoder_cross": 300}     # queries: every token, or 300
MSDA_BATCH = 16                   # the deformable cell's lanes
MSDA_LAYERS = 6                   # MSDA calls of the encoder, and of the decoder
# The MSDA kernel's products run off the tensor cores: float32 FMA at 67 TFLOP/s.
F32_SIMT_FLOPS = 67e12
MSDA_BOUND_RATE = "bytes over 3.35 TB/s, or float32 FLOP over 67 TFLOP/s (no tensor core)"


def msda_levels(img_h: int, img_w: int) -> list[tuple[int, int]]:
    """Deformable DETR's four levels of an image: strides 8, 16, 32 and 64,
    each stride-2 layer rounding up."""
    h, w = img_h, img_w
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
    levels = []
    for _ in range(4):
        levels.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return levels


def msda_inputs(batch: int, queries: int | None, dtype: torch.dtype, dev: torch.device,
                levels=MSDA_LEVELS, seed: int = 0):
    """Seeded MSDA inputs as the model makes them: (value, shapes, starts,
    locations, weights).  Values normal; reference points uniform in the
    frame, offsets of a few pixels (some samples off the map); softmaxed
    weights.  ``queries`` None: every token a query (the encoder)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = sum(h * w for h, w in levels)
    Lq = S if queries is None else queries
    L = len(levels)
    value = torch.randn(batch, S, MSDA_HEADS, MSDA_DH, generator=g, device=dev).to(dtype)
    ref = torch.rand(batch, Lq, 1, 1, 1, 2, generator=g, device=dev)
    sizes = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=dev)
    offsets = 3.0 * torch.randn(batch, Lq, MSDA_HEADS, L, MSDA_POINTS, 2, generator=g,
                                device=dev)
    locations = ref + offsets / sizes[:, None, :]
    weights = torch.softmax(torch.randn(batch, Lq, MSDA_HEADS, L * MSDA_POINTS, generator=g,
                                        device=dev), -1).view(batch, Lq, MSDA_HEADS, L,
                                                              MSDA_POINTS)
    starts = tuple(sum(h * w for h, w in levels[:i]) for i in range(L))
    return value, tuple(levels), starts, locations, weights


def msda_bar(want: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, dict]:
    """The wrapper's bar against the plain version, for each output: float32
    within 1e-5 of the largest (the sum's order, and ``grid_sample``'s pixel
    ((2 loc - 1) + 1) w / 2 - 0.5 rounds apart from the kernel's loc w -
    0.5 by ~1e-7 of it); bfloat16 within one unit in the last place (2^-7
    of the output, as both round a float32 sum once) plus the float32 bar
    (for outputs near 0)."""
    scale = float(want.abs().max())
    if dtype == torch.float32:
        return torch.full_like(want, 1e-5 * scale), {"atol": 1e-5 * scale,
                                                     "rule": "1e-5 x max|plain|"}
    return 2.0 ** -7 * want.abs() + 1e-5 * scale, {
        "rule": "2^-7 x |plain| + 1e-5 x max|plain|, each output"}


def msda_checks() -> list[dict]:
    """The MSDA wrapper (``ms_deform_attn_kernel``) at the deformable cell's
    shapes, B = 16 over its four levels: the encoder (every token a query)
    and the decoder's cross-attention (300 queries), f32 and bf16 values,
    held to :func:`~odam_torch.ops.msda.ms_deform_attn_plain` by
    :func:`msda_bar`.  The plain version with its locations rounded to
    bfloat16 must fail the same bar: the bar sees the precision the
    module's contract keeps out (float32 locations).  Device time a call
    from a CUDA graph, the plain version's too, and the bound from the row's
    own inputs (value, float32 locations and weights, and the output, each
    once; 8 dh + 8 float32 FLOP a sample)."""
    from odam_torch.ops import msda

    dev = torch.device("cuda")
    rows = []
    for case, queries in MSDA_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            value, shapes, starts, loc, w = msda_inputs(MSDA_BATCH, queries, dtype, dev)
            calls = {"": lambda: msda.ms_deform_attn(value, shapes, starts, loc, w),
                     "plain_": lambda: msda.ms_deform_attn_plain(value, shapes, starts, loc, w)}
            with torch.no_grad():
                got, want = calls[""]().float(), calls["plain_"]().float()
                rounded = msda.ms_deform_attn_plain(value, shapes, starts,
                                                    loc.to(torch.bfloat16).float(), w).float()
                bar, tol = msda_bar(want, dtype)
                err, loc_err = (got - want).abs(), (rounded - want).abs()
                where = f"ms_deform_attn {case} {str(dtype).replace('torch.', '')}"
                if not bool((err <= bar).all()):
                    raise AssertionError(f"{where}: max|kernel-plain| {float(err.max()):.3e} "
                                         f"exceeds {tol}")
                if bool((loc_err <= bar).all()):
                    raise AssertionError(f"{where}: bf16 locations pass the bar {tol}")
                times = {}
                for key, fn in calls.items():
                    times[f"{key}issue_ms"] = cuda_ms(fn)
                    times[f"{key}device_ms"] = graph_ms(fn)
            B, S, H, dh = value.shape
            Lq, samples = loc.shape[1], w.numel()
            n_bytes = (B * S * H * dh + B * Lq * H * dh) * value.element_size() + samples * 12
            flops = samples * (8.0 * dh + 8)
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_SIMT_FLOPS * 1e3
            rows.append({
                "name": "ms_deform_attn", "route": "cuda", "source": MSDA_SOURCE,
                "replaces": None, "case": f"{case} B={B}",
                "shape": {"B": B, "Lq": Lq, "S": S, "H": H, "dh": dh, "levels": shapes,
                          "points": loc.shape[4]},
                "dtype": str(dtype).replace("torch.", ""), "path": "deformable_lanes",
                "launches": None, "max_abs_err": float(err.max()), "tol": tol,
                "bf16_locations_max_abs_err": float(loc_err.max()),
                "ms": times["device_ms"], "plain_ms": times["plain_device_ms"],
                "library_ms": None, **times,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bound_rate": MSDA_BOUND_RATE, "gflop": flops / 1e9, "mbytes": n_bytes / 1e6,
            })
            del value, loc, w, got, want, rounded, bar, err, loc_err, calls
    return rows


# ----------------------------------------------------------------- sinkhorn

SINKHORN_SOURCE = "odam_torch/csrc/sinkhorn.cu"
# not a Pallas kernel: JAX's Sinkhorn is a lax.scan
SINKHORN_REPLACES = "odam_tpu/ops/sinkhorn.py:log_optimal_transport"
SINKHORN_SEED = 17
SINKHORN_ITERS = (0, 1, 3, 100)
SINKHORN_ALPHA = 1.3
# tests/test_torch_sinkhorn_kernel.py's bars: live entries (up to ~20, a
# float32 unit 1.9e-6 there) within ~5 units; entries near -1e9 to their
# relative rounding; -inf, +inf and NaN exactly where the plain version has them.
SINKHORN_LIVE_ATOL = 1e-5
SINKHORN_MASKED_RTOL = 1e-6


def sinkhorn_cases(rng, B: int = 16, M: int = 64, N: int = 30):
    """(label, scores, row_mask, col_mask) at the lane step's [16, 64, 30] on
    the card, scores as normal x 3: "lanes", stores of 48 tracks (a quarter
    of the lanes another count) and 1-30 detections; "edges", lanes in turn
    an empty store, a frame without detections, both, and a full store."""
    dev = torch.device("cuda")

    def masks(rows, cols):
        return (torch.from_numpy(np.arange(M)[None] < np.asarray(rows)[:, None]).to(dev),
                torch.from_numpy(np.arange(N)[None] < np.asarray(cols)[:, None]).to(dev))

    for label, (rows, cols) in {
            "lanes": (np.where(rng.random(B) < 0.25, rng.integers(0, M, B), 48),
                      rng.integers(1, N + 1, B)),
            "edges": (np.tile([0, 48, 0, M], B // 4), np.tile([26, 0, 0, N], B // 4))}.items():
        scores = torch.from_numpy(rng.normal(size=(B, M, N)).astype(np.float32) * 3).to(dev)
        yield (label, scores, *masks(rows, cols))


def transport_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel's log assignment against the plain version's: the largest
    gap of the live entries, the largest relative gap of those near -1e9, and
    whether the -inf, +inf and NaN entries fall in the same places."""
    g, w = got.double(), want.double()
    finite = torch.isfinite(w)
    live = finite & (w > -1e8)
    masked = finite & ~live
    same = bool(torch.equal(torch.isnan(g), torch.isnan(w))
                and torch.equal(g == math.inf, w == math.inf)
                and torch.equal(g == -math.inf, w == -math.inf))
    return {"max_abs_err": float((g - w)[live].abs().max()) if live.any() else 0.0,
            "masked_max_rel_err": (float(((g - w) / w)[masked].abs().max()) if masked.any()
                                   else 0.0),
            "non_finite_equal": same, "live": int(live.sum()), "masked": int(masked.sum()),
            "neg_inf": int((w == -math.inf).sum()), "nan": int(torch.isnan(w).sum())}


def sinkhorn_checks() -> tuple[dict, list[dict]]:
    """The Sinkhorn kernel (``log_optimal_transport`` on CUDA tensors under
    no_grad) against its plain version on the card, on ``sinkhorn_cases`` at
    each of ``SINKHORN_ITERS``: one launch a call, live entries within
    SINKHORN_LIVE_ATOL, those near -1e9 within SINKHORN_MASKED_RTOL, the
    -inf and NaN entries exactly; device time a call from a CUDA graph (the
    plain version's too, 2 calls a graph), the issue time of each, and the
    bound: bytes over 3.35 TB/s (scores, masks and the output once each)."""
    from odam_torch.ops import kernels, sinkhorn

    rng = np.random.default_rng(SINKHORN_SEED)
    alpha = torch.tensor(SINKHORN_ALPHA, device="cuda")
    rows = []
    for label, scores, rm, cm in sinkhorn_cases(rng):
        for iters in SINKHORN_ITERS:
            where = f"sinkhorn {label} iters={iters}"
            args = (scores, alpha, iters, rm, cm)
            with torch.no_grad():
                before = kernels.counts("LAUNCHES"), kernels.counts("PLAIN_CALLS")
                got = sinkhorn.log_optimal_transport(*args)
                want = sinkhorn.log_optimal_transport_plain(*args)
                torch.cuda.synchronize()
                after = kernels.counts("LAUNCHES"), kernels.counts("PLAIN_CALLS")
                if after != ({**before[0], "sinkhorn": before[0]["sinkhorn"] + 1}, before[1]):
                    raise AssertionError(f"{where}: not one launch ({after[0]}, plain "
                                         f"{after[1]})")
                gap = transport_gap(got, want)
                if not (gap["non_finite_equal"] and gap["max_abs_err"] <= SINKHORN_LIVE_ATOL
                        and gap["masked_max_rel_err"] <= SINKHORN_MASKED_RTOL):
                    raise AssertionError(f"{where}: kernel against plain {gap}")
                times = {"ms": graph_ms(lambda: sinkhorn.log_optimal_transport(*args)),
                         "issue_ms": cuda_ms(lambda: sinkhorn.log_optimal_transport(*args)),
                         "plain_ms": graph_ms(lambda: sinkhorn.log_optimal_transport_plain(*args),
                                              calls=2),
                         "plain_issue_ms": cuda_ms(
                             lambda: sinkhorn.log_optimal_transport_plain(*args), reps=5)}
            B, M, N = scores.shape
            n_bytes = 4 * B * M * N + B * (M + N) + 4 + 4 * B * (M + 1) * (N + 1)
            rows.append({
                "name": "sinkhorn", "route": "cuda", "source": SINKHORN_SOURCE,
                "replaces": SINKHORN_REPLACES, "case": f"{label} iters={iters}",
                "shape": {"B": B, "M": M, "N": N, "iters": iters},
                "dtype": "float32", "path": "scene_parallel_full",
                "launches": None, **gap,
                "tol": {"live_atol": SINKHORN_LIVE_ATOL, "masked_rtol": SINKHORN_MASKED_RTOL,
                        "non_finite": "equal"},
                **times, "library_ms": None,
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "bound_note": "bytes over 3.35 TB/s; the kernel is latency-bound: 2 x iters "
                              "dependent passes, each a max, a sum and a block barrier",
                "mbytes": n_bytes / 1e6})
    report = {"phase": "sinkhorn_checks", "cases": len(rows), "all_within_tolerance": True,
              "max_abs_err": max(r["max_abs_err"] for r in rows),
              "masked_max_rel_err": max(r["masked_max_rel_err"] for r in rows),
              "device_ms": {r["case"]: r["ms"] for r in rows},
              "plain_ms": {r["case"]: r["plain_ms"] for r in rows},
              "issue_ms": {r["case"]: r["issue_ms"] for r in rows},
              "plain_issue_ms": {r["case"]: r["plain_issue_ms"] for r in rows}}
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
    if detr_launches != {"flash_attention": 12, "fused_attention": 6, "lap_solve": 0,
                         "sinkhorn": 0, "ms_deform_attn": 0}:
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
    if assoc_launches != {"flash_attention": 0, "fused_attention": 16, "lap_solve": 1,
                          "sinkhorn": 1, "ms_deform_attn": 0}:
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
    want = {"flash_attention": 12, "fused_attention": 6, "lap_solve": 0, "sinkhorn": 0,
            "ms_deform_attn": 0}
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
    """Zero every kernel's counts (the seam's, odam_torch/ops/kernels.py)."""
    from odam_torch.ops import kernels

    kernels.zero_counts()


def _launches(on_card: bool = True) -> dict:
    """Every kernel's launches so far (off the card, its plain calls)."""
    from odam_torch.ops import kernels

    return kernels.counts("LAUNCHES" if on_card else "PLAIN_CALLS")


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
    launches, by_dtype = _snapshot()
    return ({k: n - before[k] for k, n in launches.items()},
            {k: {d: n - before_dt[k].get(d, 0) for d, n in v.items()}
             for k, v in by_dtype.items()})


def _snapshot() -> tuple[dict, dict]:
    from odam_torch.ops import kernels

    return _launches(), kernels.counts("LAUNCHES_BY_DTYPE")


def _check_dtype(where: str, by_dtype: dict, dtype: str) -> None:
    """Every launch counted in ``by_dtype`` of a kernel that has a ``dtype``
    instantiation is of it (LAP and Sinkhorn have float32 only)."""
    from odam_torch.ops import kernels

    other = {k: {d: n for d, n in v.items() if d != dtype and n} for k, v in by_dtype.items()
             if dtype in kernels.KERNELS[k].dtypes}
    if any(other.values()):
        raise AssertionError(f"{where}: launches of another dtype than {dtype}: {by_dtype}")


def slice_run(det, assoc, frames, n_frames: int = SLICE_FRAMES, profile: bool = False,
              phase: str = "slice") -> tuple[dict, dict, object]:
    """OdamPipeline at full width over ``n_frames`` YUV frames (from frame 2
    a store of 48 tracks), every frame's kernel launches checked, and all of
    them of the models' dtype.  Returns (report, launches, pipeline)."""
    from odam_torch.ops import kernels
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
                    "lap_solve": 0 if f == 0 else 1, "sinkhorn": 0 if f == 0 else 1,
                    "ms_deform_attn": 0}
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
    routes = kernels.counts("ROUTE_LAUNCHES")["lap_solve"]
    if routes != {"registers": slice_launches["lap_solve"], "shared": 0}:
        raise AssertionError(f"the {phase}'s LAP launches by route: {routes}")
    copies = kernels.counts("ALIGN_COPIES")
    if any(copies.values()):
        raise AssertionError(f"the {phase}'s attention inputs needed aligned copies: {copies}")
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
              "launches": slice_launches, "lap_route_launches": routes,
              "launches_by_dtype": kernels.counts("LAUNCHES_BY_DTYPE"), "align_copies": copies}
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
                    "lap_solve": 0 if f == 0 else 1, "sinkhorn": 0 if f == 0 else 1,
                    "ms_deform_attn": 0}
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

SP_FRAMES = 4                      # frames a lane in scene_parallel_full (3 give 6
                                   # orders, fewer than the 8 lanes' own)
SP_ORDER_SEED = 11                 # the frames, and each lane's order of them


def _lane_scenes(frames, n_lanes: int, shape) -> list[dict]:
    """``n_lanes`` scenes over the same frames, each in its own order (lane
    0 in order), so that no two lanes see the same sequence."""
    n = len(frames)
    rng = np.random.default_rng(SP_ORDER_SEED)
    orders = [tuple(range(n))]
    for _ in range(1000):            # draw until every lane has an order of its own
        if len(orders) == n_lanes:
            break
        order = tuple(int(i) for i in rng.permutation(n))
        if order not in orders:
            orders.append(order)
    if len(orders) != n_lanes:
        raise AssertionError(f"{n} frames give no {n_lanes} different orders")
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
    PipelineConfig, 800x1071 uint8 frames) at P = 1, 2, 4 and 8 lanes of
    ``n_frames`` frames each, every lane's frames in its own order; f32
    (TF32 off), then bf16.  Every lane is held to the serial f32 pipeline on its frames:
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
    from odam_torch.ops import kernels
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
    by_batch, assoc_launches = {}, {}
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
            batches = kernels.counts("LAUNCHES_BY_BATCH")
            syncs = rec["synchronizing_calls"]
            if on_card and any(syncs[2:]):     # every lane holds a track from step 2 on
                raise AssertionError(f"{where}: synchronizing CUDA calls by step {syncs}")
            for name in ("lap_solve", "sinkhorn"):   # every lane's transport and decode: one each
                if launches[name] != n_frames:
                    raise AssertionError(f"{where}: {launches[name]} {name} launches in "
                                         f"{n_frames} steps")
            totals = assoc_launches.setdefault(dtype, {})
            for name in ("lap_solve", "sinkhorn", "ms_deform_attn"):
                totals[name] = totals.get(name, 0) + launches[name]
            peak = torch.cuda.max_memory_allocated() - resident if on_card else None
            if on_card and any(set(b) != {P} for b in batches.values()):
                raise AssertionError(f"{where}: launches by batch {batches}, not all at B = {P}")
            for name, b in batches.items():
                by_batch.setdefault(dtype, {}).setdefault(name, {})[P] = b.get(P, 0)
            if any(kernels.counts("ALIGN_COPIES").values()):
                raise AssertionError(f"{where}: aligned copies {kernels.counts('ALIGN_COPIES')}")
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
    counts = {dtype: {**{name: sum(b.values()) for name, b in per.items()}, **assoc_launches[dtype]}
              for dtype, per in by_batch.items()}
    return report, counts


DEFORMABLE_YAML = os.path.join("odam_torch", "configs", "deformable_detr_scan_net.yaml")


def deformable_lanes_run(device: str = "cuda", shape=SLICE_SHAPE, n_lanes: int = MSDA_BATCH,
                         n_frames: int = SP_FRAMES) -> tuple[dict, dict]:
    """Deformable DETR (``DEFORMABLE_YAML`` through ``detector_from_cfg``,
    seeded weights) and the YAML's associator through SceneParallelRunner,
    as the deformable benchmark cell runs them: ``n_lanes`` lanes of
    ``n_frames`` uint8 frames, each lane in its own order.  Three runs on
    the same frames: f32 with the kernels, f32 on the plain route
    (``use_kernels=False``, the same weights), bf16 with the kernels.  The
    kernel counters are zeroed just before each run and read just after it: 12 MSDA calls a step (6 encoder, 6 decoder), launches of
    the run's dtype on the kernel runs and plain calls on the plain run,
    ``SAMPLES`` = steps x lanes x 6 x (tokens + queries) x heads x levels x
    points; one LAP launch a step; the flash kernel (the decoder's
    self-attention over 300 queries) and the fused kernel (the GNN) launched
    on the card's kernel runs.  The f32 kernel run's lanes equal the plain
    run's: detections a frame and track ids exact, rows by
    :func:`_hold_lane`.  Returns the report and the two kernel runs'
    launches as paths."""
    from odam_torch import config as config_mod
    from odam_torch.models import associator, detr
    from odam_torch.ops import kernels
    from odam_torch.runtime import processor, scene_parallel

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    img_h, img_w = shape
    yaml_cfg = config_mod.merge_cfg([DEFORMABLE_YAML])
    cfg = processor.PipelineConfig(detect_threshold=0.0, score_threshold=0.0)
    rng = np.random.default_rng(SP_ORDER_SEED)
    frames = [rng.integers(0, 256, size=tuple(shape) + (3,), dtype=np.uint8)
              for _ in range(n_frames)]
    scenes = _lane_scenes(frames, n_lanes, shape)
    levels = msda_levels(img_h, img_w)
    queries = int(yaml_cfg["num_queries"])
    samples = (n_frames * n_lanes * MSDA_LAYERS * (sum(h * w for h, w in levels) + queries)
               * int(yaml_cfg["nheads"]) * len(levels) * int(yaml_cfg["enc_n_points"]))
    calls = 2 * MSDA_LAYERS * n_frames
    report = {"phase": "deformable_lanes", "config": DEFORMABLE_YAML, "image": [img_h, img_w],
              "lanes": n_lanes, "frames_per_lane": n_frames, "levels": levels,
              "queries": queries, "runs": {}}
    paths, kept = {}, {}
    for run, dtype, use_kernels in (("float32", torch.float32, True),
                                    ("float32_plain", torch.float32, False),
                                    ("bfloat16", torch.bfloat16, True)):
        where = f"deformable_lanes {run}"
        det = detr.init_detector(detr.detector_from_cfg(yaml_cfg, dtype=dtype,
                                                        use_kernels=use_kernels), seed=0,
                                 device=dev)
        assoc = associator.build_associator(associator.AssociatorConfig.from_cfg(
            yaml_cfg, dtype=dtype), seed=1, device=dev)
        runner = scene_parallel.SceneParallelRunner(det, assoc, cfg, n_lanes, device=dev)
        resident = _reset_peak(dev)
        _reset_counts()
        t0 = time.perf_counter()
        (stores, logs), rec = _run_lanes(runner, scenes, img_h, img_w)
        seconds = time.perf_counter() - t0
        launches = _launches(on_card)
        counted = {key: kernels.counts(key)["ms_deform_attn"] for key in kernels.GROUPS["msda"]}
        routed = use_kernels and on_card
        want = {"LAUNCHES": calls if routed else 0, "PLAIN_CALLS": 0 if routed else calls,
                "SAMPLES": samples}
        if {k: counted[k] for k in want} != want or (
                routed and counted["LAUNCHES_BY_DTYPE"][str(dtype).split(".")[1]] != calls):
            raise AssertionError(f"{where}: MSDA counters {counted}, expected {want}")
        for name in ("lap_solve", "sinkhorn"):     # the associator's kernels either way
            if launches[name] != n_frames:
                raise AssertionError(f"{where}: {launches[name]} {name} launches in "
                                     f"{n_frames} steps")
        if routed and not (launches["flash_attention"] and launches["fused_attention"]):
            raise AssertionError(f"{where}: attention launches {launches}")
        if not (torch.isfinite(stores.window).all() and torch.isfinite(logs.rows).all()):
            raise AssertionError(f"{where}: non-finite track store or log")
        lanes_out = [(rec["n_detections"][:, lane].tolist(),
                      logs.rows[lane, :n_frames].cpu().numpy(),
                      logs.ids[lane, :n_frames].cpu().numpy()) for lane in range(n_lanes)]
        if dtype == torch.float32:
            kept[run] = lanes_out
        report["runs"][run] = {
            "dtype": str(dtype).replace("torch.", ""), "use_kernels": use_kernels,
            "seconds": seconds, "step_ms": rec["ms"], "msda": counted, "launches": launches,
            "synchronizing_calls_by_step": rec["synchronizing_calls"],
            "peak_mbytes_above_resident": ((torch.cuda.max_memory_allocated() - resident) / 1e6
                                           if on_card else None),
            "n_detections_per_lane": rec["n_detections"].sum(axis=0).tolist()}
        if use_kernels:
            paths["deformable_lanes" if dtype == torch.float32 else "deformable_lanes_bf16"] = \
                launches
        del det, assoc, runner, stores, logs
    worst = 0.0
    for lane, ((n, rows, ids), (n_ref, rows_ref, ids_ref)) in enumerate(
            zip(kept["float32"], kept["float32_plain"])):
        where = f"deformable_lanes lane {lane}"
        if n != n_ref or not np.array_equal(ids, ids_ref):
            raise AssertionError(f"{where}: detections {n} or track ids differ from the plain "
                                 f"route's ({n_ref})")
        worst = max(worst, _hold_lane(where, "float32", rows, rows_ref, img_h, img_w))
    report.update(max_row_abs_diff_plain=worst,
                  tol={"atol": DETR_ATOL, "rtol": DETR_RTOL, "msda_calls_per_step":
                       2 * MSDA_LAYERS})
    return report, paths


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


SP_HARD_FRAMES = 16       # frames a scene in scene_parallel_hard (the split has 32)


def scene_parallel_hard_run(scene_f1: dict, out_root: str = os.path.join("chiprun_out", "sp_hard"),
                            device: str = "cuda", lanes: tuple[int, ...] = (3, 4),
                            max_frames: int | None = SP_HARD_FRAMES) -> tuple[dict, dict]:
    """SceneParallelRunner on the committed hard split (3 scenes, their
    first ``max_frames`` frames at 192x192) with the committed weights and
    the scene phase's flags, at each P of ``lanes`` (P = 3: a lane a scene;
    P = 4: one lane of padding), against the serial OdamPipeline on the same
    frames and device: tracks of every scene with frame ids and classes
    exact and rows within SCENE_ROW_ATOL, and the F1 table equal to the
    serial run's (with every frame, ``max_frames=None``: to the scene
    phase's, ``scene_f1``).  fused_attention must launch at B = P (144 image
    tokens: no flash)."""
    from odam_torch import config as config_mod
    from odam_torch.data import scannet
    from odam_torch.ops import kernels
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
    serial_f1 = _f1(os.path.join(out_root, "serial"), scene_ids)
    want_f1, want_of = (scene_f1, "the scene phase's") if max_frames is None else (
        serial_f1, "the serial run's")
    report = {"phase": "scene_parallel_hard", "device": device,
              "frames": [len(s["frames"]) for s in scenes], "serial_seconds": serial_s,
              "f1_serial": serial_f1["average"], "lanes": {}}
    counts = {name: 0 for name in _launches()}
    for P in lanes:
        _reset_counts()
        runner = scene_parallel.SceneParallelRunner(det, assoc, cfg, P, device=dev)
        t0 = time.perf_counter()
        outs = runner.run_scenes(scenes, img_h, img_w)
        seconds = time.perf_counter() - t0
        launched = _launches(dev.type == "cuda")
        by_batch = kernels.counts("LAUNCHES_BY_BATCH")
        if dev.type == "cuda" and (by_batch["fused_attention"].get(P, 0) == 0
                                   or launched["flash_attention"]):
            raise AssertionError(f"scene_parallel_hard P={P}: launches by batch {by_batch}")
        out_dir = os.path.join(out_root, f"P{P}")
        _write_results(out_dir, scene_ids, outs)
        f1 = _f1(out_dir, scene_ids)
        if f1 != want_f1:
            raise AssertionError(f"scene_parallel_hard P={P}: F1 {f1['average']} differs from "
                                 f"{want_of} {want_f1['average']}")
        report["lanes"][f"P={P}"] = {
            **_compare_results(f"scene_parallel_hard P={P}", outs, serial),
            "seconds": seconds, "f1_equals": want_of, "f1": f1["average"],
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
    from odam_torch.ops import kernels
    from odam_torch.scripts import eval_scan2cad, run_processor

    scene_ids, flags = _scene_flags()
    _reset_counts()
    t0 = time.perf_counter()
    if run_processor.main(flags + ["--out_dir", out_root, "--device", device,
                                   "--scene_parallel", str(n_lanes)]) != 0:
        raise AssertionError("run_processor --scene_parallel failed")
    seconds = time.perf_counter() - t0
    counts = _launches(device == "cuda")
    by_batch = kernels.counts("LAUNCHES_BY_BATCH")
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
    plain calls on the CPU, and both split by dtype."""
    from odam_torch.ops import kernels

    on_card = dev.type == "cuda"
    return _launches(on_card), kernels.counts("LAUNCHES_BY_DTYPE" if on_card
                                              else "PLAIN_CALLS_BY_DTYPE")


def _counted(dev: torch.device, fn, *args):
    """``fn(*args)`` and the kernel calls it made on ``dev``: (result,
    calls by kernel, attention calls by kernel and dtype)."""
    before, before_dt = _counts_of(dev)
    result = fn(*args)
    after, after_dt = _counts_of(dev)
    return (result, {k: n - before[k] for k, n in after.items()},
            {k: {d: n - before_dt[k].get(d, 0) for d, n in v.items()} for k, v in after_dt.items()})


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


SCENE_CPU_SHARDS = 3      # the scene phase's CPU run: processes at once, a scene each
SCENE_CPU_THREADS = 2     # torch threads of each


def scene_cli_run(device: str, out_dir: str, shard: str | None = None,
                  json_out: str | None = None) -> dict:
    """One run of the scene phase's CLI chain (``_run_cli``, every frame's
    kernel calls recorded): its frames, seconds, scene seconds and calls.
    With ``shard`` ("i/n", ``run_processor --shard``) it runs the i-th of n
    shards of the scenes at SCENE_CPU_THREADS threads and writes the run to
    ``json_out``: a process of :func:`_scene_shards`."""
    _, common = _scene_flags()
    argv = common + ["--out_dir", out_dir, "--device", device]
    if shard:
        torch.set_num_threads(SCENE_CPU_THREADS)
        argv += ["--shard", shard]
    _reset_counts()
    frames, scene_s, seconds = _run_cli(argv)
    run = {"frames": frames, "seconds": seconds, "scene_seconds": scene_s,
           "counts": _launches(device == "cuda")}
    if json_out:
        with open(json_out, "w") as f:
            json.dump(run, f)
    return run


def _scene_shards(device: str, out_dir: str, log_root: str) -> dict:
    """The scene phase's CLI chain on ``device`` in SCENE_CPU_SHARDS processes
    at once, each a shard of the scenes into ``out_dir``; their runs merged
    (frames, scene seconds, calls summed), with the wall time as seconds."""
    t0 = time.perf_counter()
    logs = [os.path.join(log_root, f"{device}_shard{i}") for i in range(SCENE_CPU_SHARDS)]
    procs = []
    try:
        for i, log in enumerate(logs):
            with open(log + ".log", "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", f"import chip_smoke; chip_smoke.scene_cli_run("
                     f"{device!r}, {out_dir!r}, '{i}/{SCENE_CPU_SHARDS}', {log + '.json'!r})"],
                    cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
                    stderr=subprocess.STDOUT))
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = []
    for log, code in zip(logs, codes):
        if code != 0:
            with open(log + ".log") as f:
                raise AssertionError(f"scene: a {device} shard failed: {f.read()[-3000:]}")
        with open(log + ".json") as f:
            runs.append(json.load(f))
    return {"frames": [fr for r in runs for fr in r["frames"]],
            "seconds": time.perf_counter() - t0,
            "scene_seconds": {k: v for r in runs for k, v in r["scene_seconds"].items()},
            "counts": {k: sum(r["counts"][k] for r in runs) for k in runs[0]["counts"]}}


def scene_run(out_root: str = os.path.join("chiprun_out", "scene"),
              devices: tuple[str, str] = ("cuda", "cpu")) -> tuple[dict, dict]:
    """The CLI chain on the committed hard split's three scenes with the
    committed weights, on the card and then on the CPU (:func:`_scene_shards`,
    once the card's run is over); eval_scan2cad on both.

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
    from odam_torch.utils.host_boxes import robust_box3d_iou

    scenes, _ = _scene_flags()
    card, cpu = devices
    os.makedirs(out_root, exist_ok=True)
    runs = {card: scene_cli_run(card, os.path.join(out_root, card))}
    runs[cpu] = _scene_shards(cpu, os.path.abspath(os.path.join(out_root, cpu)), out_root)
    results, f1 = {}, {}
    for device in devices:
        results[device] = {}
        for s in scenes:
            with open(os.path.join(out_root, device, s, s), "rb") as f:
                results[device][s] = pickle.load(f)
        f1[device] = scan2cad.evaluate(os.path.join(out_root, device),
                                       os.path.join(SCENE_DATA, "full_annotations.json"),
                                       os.path.join(SCENE_DATA, "scans"), scenes,
                                       min_views=10, verbose=device == card)
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
                    "lap_solve": int(fr["associated"] and fr["exact_decode"]),
                    "sinkhorn": int(fr["associated"]), "ms_deform_attn": 0}
            got = {k: fr[k] for k in want}
            if got != want:
                raise AssertionError(f"{device} frame {fr['frame']}: attention calls {got}, "
                                     f"expected {want}")
    frames = runs[card]["frames"]
    report = {"phase": "scene", "scenes": per_scene, "f1": f1[card],
              "f1_card_equals_cpu": True,
              "cpu_run": (f"after the card's, in {SCENE_CPU_SHARDS} processes at once: "
                          f"a shard of the scenes and {SCENE_CPU_THREADS} torch threads each"),
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
    Sinkhorn kernel once, and the LAP kernel once with the exact decode (not
    with ``--profile fast``'s greedy one)."""
    if entry.get("detect"):
        return {"flash_attention": 0, "fused_attention": 0, "lap_solve": 0, "sinkhorn": 0,
                "ms_deform_attn": 0}
    gnn = 16 if entry["associated"] else 0
    assoc = {"lap_solve": int(entry["associated"] and entry["exact_decode"]),
             "sinkhorn": int(entry["associated"]), "ms_deform_attn": 0}
    if offline:
        return {"flash_attention": 0, "fused_attention": gnn, **assoc}
    return {"flash_attention": 12, "fused_attention": 6 + gnn, **assoc}


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

    from odam_torch.ops import kernels

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
              "launches": counts, "align_copies": kernels.counts("ALIGN_COPIES")}
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
    attention = {k: n for k, n in launches.items() if k not in ("lap_solve", "sinkhorn")}
    if any(attention.values()):
        raise AssertionError(f"{phase}: attention kernels launched {attention}")
    if launches["sinkhorn"]:        # training's transport is the plain version's
        raise AssertionError(f"{phase}: the Sinkhorn kernel launched {launches['sinkhorn']} times")
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
        launched = {k: n for k, n in _launches().items() if k != "lap_solve" and n}
        if launched:
            raise AssertionError(f"train_detector: kernels launched {launched}")
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


RESUME_RTOL = 1e-3        # train_detector resumed at step 2 against uninterrupted, step 3


def train_cli_run(out_root: str = os.path.join("runs", "train_cli"),
                  device: str = "cuda", extra_det: tuple[str, ...] = (),
                  extra_assoc: tuple[str, ...] = (), config: str = TRAIN_CONFIG,
                  short_side: int = 512) -> tuple[dict, dict]:
    """Both train CLIs as a user runs them (``python -m``, ``--synthetic
    --steps 3``, the scripts' defaults otherwise), then their ``ckpt_3``
    directories through ``run_processor.build_models`` and a 2-frame
    ``run_processor`` run of one committed scene with them (bf16, the
    kernels on; a 16 x 16 mapping capacity, as the run holds one or two
    tracks).  ``train_detector`` also saves at step 2, and a fresh process
    resumes from there (``--resume_ckpt``: parameters, optimizer state and
    the batch stream) to step 3, whose logged loss must be the
    uninterrupted run's within RESUME_RTOL.  The outputs go under ``runs/``
    (gitignored): a full-width checkpoint with its optimizer state is about
    0.5 GB."""
    import pickle

    from odam_torch import config as config_mod
    from odam_torch.scripts import run_processor
    from odam_torch.utils import checkpoint

    os.makedirs(out_root, exist_ok=True)
    ckpts, seconds, cli_losses = {}, {}, {}

    def train(name, out_dir, extra, steps):
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = [sys.executable, "-m", f"odam_torch.scripts.{name}", "--synthetic",
                "--steps", "3", "--log_every", "1", "--config_path", config,
                "--out_dir", out_dir, "--device", device, *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(argv[1:])} failed:\n{proc.stderr[-3000:]}")
        if (checkpoint.load_meta(os.path.join(out_dir, "ckpt_3")) or {}).get("step") != 3:
            raise AssertionError(f"{name}: no complete ckpt_3")
        with open(os.path.join(out_dir, "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        key = "total" if name == "train_detector" else "loss"
        if [r["step"] for r in log] != steps or not all(np.isfinite(r[key]) for r in log):
            raise AssertionError(f"{name}: log {log}")
        return [r[key] for r in log], time.perf_counter() - t0

    for name, extra in (("train_detector", (*extra_det, "--save_every", "2")),
                        ("train_associator", extra_assoc)):
        out_dir = os.path.join(out_root, name)
        cli_losses[name], seconds[name] = train(name, out_dir, extra, [1, 2, 3])
        ckpts[name] = os.path.join(out_dir, "ckpt_3")
    # a fresh process resumes train_detector at its step-2 checkpoint
    resumed, seconds["train_detector_resumed"] = train(
        "train_detector", os.path.join(out_root, "train_detector_resumed"),
        (*extra_det, "--resume_ckpt", os.path.join(out_root, "train_detector", "ckpt_2")), [3])
    uninterrupted = cli_losses["train_detector"][-1]
    resume_rel = abs(resumed[0] - uninterrupted) / abs(uninterrupted)
    if not resume_rel <= RESUME_RTOL:
        raise AssertionError(f"train_detector --resume_ckpt: step-3 loss {resumed[0]} against "
                             f"the uninterrupted {uninterrupted} (rel {resume_rel:.3e})")
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
              "resume": {"resumed_step3_loss": resumed[0], "uninterrupted_step3_loss":
                         uninterrupted, "rel": resume_rel, "rtol": RESUME_RTOL},
              "checkpoints": ckpts, "run_processor_frames": len(frames),
              "run_processor_tracks": len(out["tracks"]), "run_processor_seconds": run_s,
              "launches": counts}
    return report, counts


DIST_SIZE = "full"                 # dryrun_distributed's full-width models
CLI_DIST_SCENES = 1                # cli_dist's scenes of the hard split
DIST_TIMEOUT_S = 600.0             # a spawned job's ranks in all: a hung collective fails


def _dist_rank(report: dict, on_card: bool) -> dict:
    """One rank's numbers of a dryrun_distributed job."""
    lanes = report["lanes"]
    ar = report["detr_train"].get("allreduce_ms")
    kind = "launches" if on_card else "plain_calls"
    return {"rank": report.get("rank", 0), "seconds": report["seconds"],
            "train_step_ms": {"detr": report["detr_train"]["step_ms"],
                              "assoc": report["assoc_train"]["step_ms"]},
            "grad_allreduce_ms": ar,
            "grad_allreduce_ms_median": None if ar is None else float(np.median(ar)),
            "grad_allreduce_floats": report["detr_train"]["trained_floats"],
            "peak_bytes_by_stage": report["peak_bytes"],
            "lanes_this_rank": lanes["lanes_this_rank"],
            "launches_by_stage": {k: report[k][kind] for k in ("detect", "lanes")},
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
            attention = [lanes[k] for k in ("flash_attention", "fused_attention")]
            # the tiny CPU rehearsal's images are too small for the flash kernel
            if any(n == 0 for n in (attention if on_card else [sum(attention)])):
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


def cli_dist_run(scene_dir: str = os.path.join("chiprun_out", "scene", "cuda"),
                 out_root: str = os.path.join("runs", "cli_dist"),
                 device: str = "cuda", n_lanes: int = 4, ranks: int = 2,
                 extra_train: tuple[str, ...] = (), short_side: int = 512,
                 n_scenes: int = CLI_DIST_SCENES) -> dict:
    """Both CLIs on ``ranks`` gloo ranks under ``python -m
    torch.distributed.run``: ``run_processor --scene_parallel 4`` on the
    first ``n_scenes`` scenes of the hard split with the scene phase's
    flags, then ``eval_scan2cad``, whose F1 table must equal that of the
    scene phase's results in ``scene_dir`` on the same scenes (the lanes pad
    a scene short of P); then 3 steps of ``train_detector
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
    scene_ids = scene_ids[:n_scenes]
    os.makedirs(out_root)
    scenes = os.path.join(out_root, "scenes.txt")
    with open(scenes, "w") as f:
        f.write("\n".join(scene_ids) + "\n")
    flags[flags.index("--sequences") + 1] = scenes
    scene_f1 = _f1(scene_dir, scene_ids)
    result_dir = os.path.join(out_root, "result")
    stdout, sp_seconds = run(["odam_torch.scripts.run_processor", *flags, "--out_dir",
                              result_dir, "--device", device, "--scene_parallel", str(n_lanes),
                              "--dist_backend", "gloo"], "run_processor")
    f1 = eval_scan2cad.main(["--result_dir", result_dir,
                             "--scan2cad", os.path.join(SCENE_DATA, "full_annotations.json"),
                             "--scans_root", os.path.join(SCENE_DATA, "scans"),
                             "--val_split", scenes,
                             "--min_views", "10"])
    if f1 != scene_f1:
        raise AssertionError(f"cli_dist: F1 {f1['average']} differs from the scene phase's "
                             f"{scene_f1['average']} on {scene_ids}")
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
    return {"phase": "cli_dist", "ranks": ranks, "backend": "gloo", "scenes": scene_ids,
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
                "lap_solve": 0, "sinkhorn": 0, "ms_deform_attn": 0}
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
    want = {"flash_attention": 4 * frames, "fused_attention": 2 * frames, "lap_solve": 0,
            "sinkhorn": 0, "ms_deform_attn": 0}
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
    if calls != {"flash_attention": 0, "fused_attention": 16 * frames, "lap_solve": frames,
                 "sinkhorn": frames, "ms_deform_attn": 0}:
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


# -------------------------------------------------------------------- tools

TOOLS_DIR = os.path.join("runs", "tools")    # traces and the crash demo's runs
# the cut depths of the tools phase (each tool's own defaults otherwise:
# 800x1071, bf16, full-width seeded models)
TOOL_ARGS = {
    "bench_attention": ["--iters", "10"],                # f32, then bf16
    "profile_pipeline": ["--iters", "10", "--frames", "30"],
    "ab_step_input": ["--frames", "10"],                 # a pass, 2 passes a form
    "bench_scene_parallel": ["--lanes", "1", "8", "--passes", "2"],
    "bench_batched_detection": ["--batches", "1,4,8,16", "--iters", "8"],
    "profile_batched_detector": ["--batch", "16", "--passes", "3", "--reps", "5",
                                 "--per_stage"],
    "lm_envelope_sweep": [],                             # its defaults
    # the rehearsal trainer's detector mode (ResNet-50 DETR at 128x128, batch 8)
    "crash_recovery_demo": ["--mode", "detector", "--steps", "8", "--bank", "3"],
}
TOOL_ENV = {"ab_step_input": {"ODAM_AB_PASSES": "2"},
            "bench_scene_parallel": {"ODAM_BENCH_FRAMES": "8"}}
SWEEP_CHECK = ["--views", "8", "--samples", "32", "--lm_iters", "3", "--adam_iters", "5"]
# card against CPU, a cell's LM and Adam IoU at SWEEP_CHECK: f32 solves in
# another order (tests/test_torch_tools.py holds the CPU to JAX within 2e-3)
SWEEP_IOU_ATOL = 1e-2
# resumed against uninterrupted final loss, relative: JAX's allowance (a
# segment restart builds a fresh optimizer in both packages)
CRASH_TOL = 0.15
CRASH_SAVE_DELAY_S = 0.5


def slow_save_site(site_dir: str, seconds: float) -> str:
    """Write ``site_dir/sitecustomize.py``, which makes every checkpoint write
    of ``odam_torch`` sleep ``seconds`` once its ``.tmp`` directory exists
    (before ``params.npz``), and return ``site_dir``.  On a trainer's
    ``PYTHONPATH`` it holds each save open, so that crash_recovery_demo's
    kill lands inside one in every run.  It first runs the sitecustomize it
    shadows, if the interpreter has one."""
    os.makedirs(site_dir, exist_ok=True)
    with open(os.path.join(site_dir, "sitecustomize.py"), "w") as f:
        f.write(f"""import os, runpy, sys, time
_here = os.path.dirname(os.path.abspath(__file__))
for _p in sys.path:
    _f = os.path.join(_p or ".", "sitecustomize.py")
    if os.path.abspath(_p or ".") != _here and os.path.isfile(_f):
        runpy.run_path(_f)
        break
from odam_torch.models import convert as _convert
_save = _convert.save_flax_npz


def _slow_save(*args, **kwargs):
    time.sleep({seconds!r})
    return _save(*args, **kwargs)


_convert.save_flax_npz = _slow_save
""")
    return site_dir


def _kernel_events(trace_dir: str) -> int:
    """CUDA kernel events in the newest Chrome trace under ``trace_dir``."""
    newest = max((os.path.join(trace_dir, f) for f in os.listdir(trace_dir)),
                 key=os.path.getmtime)
    with open(newest) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel")


@contextlib.contextmanager
def _env_set(env: dict):
    """``env`` set in ``os.environ`` inside the block, as it was after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _with_env(env: dict, fn):
    with _env_set(env):
        return fn()


def tools_run(device: str = "cuda", out_root: str = TOOLS_DIR) -> tuple[dict, dict, dict]:
    """The eight tools of ``odam_torch/scripts`` in-process through their
    ``main(argv)`` with TOOL_ARGS (cut depths; each tool's defaults
    otherwise: 800x1071, bf16, full-width seeded models) and TOOL_ENV, each
    tool's launches by kernel and dtype
    counted.  Holds: every kernel error within its bar, fused launched at
    1050 and 400 keys, every MFU below 100%, the per-stage prefix times
    increasing with k, ab_step_input's forms equal in track ids, the trace
    holding CUDA kernel events, the crash demo within CRASH_TOL after a kill
    that landed mid-save, the sweep's card rows within SWEEP_IOU_ATOL of the
    CPU's.  Returns (report, launches by path, bench_attention's rows)."""
    from odam_torch.ops import kernels
    from odam_torch.scripts import (ab_step_input, bench_attention, bench_batched_detection,
                                    bench_scene_parallel, crash_recovery_demo,
                                    lm_envelope_sweep, profile_batched_detector,
                                    profile_pipeline)
    from odam_torch.utils.metrics import device_banner

    dev = ["--device", device]
    report = {"phase": "tools", "device": device_banner(torch.device(device)),
              "args": TOOL_ARGS, "env": TOOL_ENV, "tools": {}}
    paths = {}

    def run(name, fn):
        _reset_counts()
        t0 = time.perf_counter()
        out = fn()
        paths[f"tools:{name}"] = _launches(device == "cuda")
        report["tools"][name] = {
            "seconds": time.perf_counter() - t0, "launches": paths[f"tools:{name}"],
            "launches_by_dtype": kernels.counts("LAUNCHES_BY_DTYPE"),
            "launches_by_batch": kernels.counts("LAUNCHES_BY_BATCH")}
        return out

    # 1. bench_attention, f32 then bf16: errors against the f32 plain result
    attn_rows = run("bench_attention", lambda: [
        row for dtype in ("float32", "bfloat16")
        for row in bench_attention.main(dev + TOOL_ARGS["bench_attention"] +
                                        ["--dtype", dtype])])
    for row in attn_rows:
        for col in ("fused", "flash"):
            bar = (F32_ATOL[f"{col}_attention"] if row["dtype"] == "float32"
                   else BF16_ROUNDINGS * 2.0 ** -8 * row["ref_max_abs"])
            if not row[f"err_{col}"] <= bar:
                raise AssertionError(f"bench_attention {row['case']} {row['dtype']} {col}: "
                                     f"error {row[f'err_{col}']:.3e} above {bar:.3e}")
        if device == "cuda" and row["shape"]["Lk"] >= 256 and not row["fused_launches"]:
            raise AssertionError(f"bench_attention {row['case']}: fused_attention not launched")
    report["tools"]["bench_attention"]["rows"] = attn_rows

    # 2. profile_pipeline with a trace
    trace_dir = os.path.join(out_root, "profile_pipeline_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    pp = run("profile_pipeline", lambda: profile_pipeline.main(
        dev + TOOL_ARGS["profile_pipeline"] + ["--trace", trace_dir]))
    events = _kernel_events(trace_dir)
    if device == "cuda" and not events:
        raise AssertionError("profile_pipeline: the trace holds no CUDA kernel event")
    report["tools"]["profile_pipeline"].update(stages_ms=pp["stages_ms"],
                                               trace_kernel_events=events)

    # 3. ab_step_input: the three forms give the same track ids
    ab = run("ab_step_input", lambda: _with_env(TOOL_ENV["ab_step_input"], lambda: (
        ab_step_input.main(dev + TOOL_ARGS["ab_step_input"]))))
    if not all(ab["ids_equal_float32"].values()):
        raise AssertionError(f"ab_step_input: track ids differ by form {ab['ids_equal_float32']}")
    report["tools"]["ab_step_input"].update(fps=ab["fps"], ids_equal=ab["ids_equal_float32"])

    # 4. bench_scene_parallel: both kernels at B = 8
    sp = run("bench_scene_parallel", lambda: _with_env(
        TOOL_ENV["bench_scene_parallel"],
        lambda: bench_scene_parallel.main(dev + TOOL_ARGS["bench_scene_parallel"])))
    by_batch = report["tools"]["bench_scene_parallel"]["launches_by_batch"]
    if device == "cuda" and not all(by_batch[k].get(8) for k in by_batch):
        raise AssertionError(f"bench_scene_parallel: a kernel not launched at B = 8: {by_batch}")
    report["tools"]["bench_scene_parallel"]["fps"] = sp["fps"]

    # 5. bench_batched_detection: MFU below 100%; the kernels at batch 1 only
    bbd = run("bench_batched_detection", lambda: bench_batched_detection.main(
        dev + TOOL_ARGS["bench_batched_detection"]))
    by_batch = report["tools"]["bench_batched_detection"]["launches_by_batch"]
    if device == "cuda" and any(set(v) != {1} for v in by_batch.values()):
        raise AssertionError(f"bench_batched_detection: kernel launches by batch {by_batch}")
    mfus = [r["mfu"] for r in bbd["rows"] if r["mfu"] is not None]
    if not all(0 < m < 1 for m in mfus):
        raise AssertionError(f"bench_batched_detection: MFU {mfus}")
    report["tools"]["bench_batched_detection"].update(
        {k: bbd[k] for k in ("peak_tflops", "gflop_per_frame", "rows")})

    # 6. profile_batched_detector: MFU below 100%, prefixes increasing
    pbd = run("profile_batched_detector", lambda: profile_batched_detector.main(
        dev + TOOL_ARGS["profile_batched_detector"]))
    for B, r in pbd["batches"].items():
        shares = [v["mfu"] for v in (*r["stages"].values(), *r["per_stage"].values())
                  if v["mfu"] is not None] + [r["whole_program_mfu"] or 0.0]
        if not all(m < 100 for m in shares):
            raise AssertionError(f"profile_batched_detector B={B}: an MFU at or above 100%")
        pre = [r["prefix_ms"][k] for k in sorted(r["prefix_ms"])]
        if pre != sorted(pre) or len(set(pre)) != len(pre):
            raise AssertionError(f"profile_batched_detector B={B}: prefix ms {pre} not "
                                 "increasing with k")
    report["tools"]["profile_batched_detector"]["batches"] = pbd["batches"]

    # 7. lm_envelope_sweep: defaults on the card, then card against CPU
    run("lm_envelope_sweep",
        lambda: lm_envelope_sweep.main(dev + TOOL_ARGS["lm_envelope_sweep"]))
    card, _, card_corners = lm_envelope_sweep.main(dev + SWEEP_CHECK)
    cpu, _, cpu_corners = lm_envelope_sweep.main(["--device", "cpu"] + SWEEP_CHECK)
    diff = float(np.abs(np.array([r[3:5] for r in card]) - np.array([r[3:5] for r in cpu])).max())
    if not diff <= SWEEP_IOU_ATOL:
        raise AssertionError(f"lm_envelope_sweep: card vs CPU IoU {diff:.3e} above "
                             f"{SWEEP_IOU_ATOL}")
    report["tools"]["lm_envelope_sweep"].update(
        check=SWEEP_CHECK, max_iou_diff_card_vs_cpu=diff, iou_atol=SWEEP_IOU_ATOL,
        corners_equal=card_corners == cpu_corners)

    # 8. crash_recovery_demo: trainer processes with their saves slowed
    site = slow_save_site(os.path.join(out_root, "slow_save_site"), CRASH_SAVE_DELAY_S)
    env = {"PYTHONPATH": site + os.pathsep + os.environ.get("PYTHONPATH", "")}
    crash = run("crash_recovery_demo", lambda: _with_env(env, lambda: crash_recovery_demo.main(
        dev + TOOL_ARGS["crash_recovery_demo"] + [
            "--tol", str(CRASH_TOL), "--workdir", os.path.join(out_root, "crash")])))
    if not (crash["killed_mid_save"] and crash["within_tolerance"]):
        raise AssertionError(f"crash_recovery_demo: {crash}")
    report["tools"]["crash_recovery_demo"].update(
        result=crash, tol=CRASH_TOL, launches="in the trainer's processes: not counted here")
    del paths["tools:crash_recovery_demo"]
    return report, paths, attn_rows


EXAMPLES_OUT = os.path.join("chiprun_out", "examples")   # the dataset the phase writes
EXAMPLES_WORK = os.path.join("runs", "examples")         # checkpoints, removed at the end
# the phase's depths: the scripts' own, but for the closed loop (50 + 50 steps
# of its 8 x 400) and the rehearsal trainer (20 steps a mode)
EXAMPLE_DEPTH = {"map_iters": 200, "fit_iters": 2000, "assoc_steps": 400, "loop_steps": 50,
                 "train_steps": 20, "train_batch": 8}
FIT_L1_MAX = 1e-2             # the demo reaches ~1e-3 at 2000 iterations
EXAMPLE_F1_ATOL = 0.05        # card against CPU after 400 Adam steps, each its own trajectory
EXAMPLE_CPU_THREADS = 4       # the CPU references' process, beside the card's


def _held_out_heads(ckpt: str, device: str) -> dict:
    """The closed loop's held-out view through the DETR of ``ckpt`` on
    ``device`` (the kernels on, as segment_eval runs it): its raw heads."""
    from odam_torch.examples.closed_loop import closed_scene, segment_eval
    from odam_torch.models import detr
    from odam_torch.utils import checkpoint

    params, _, _ = checkpoint.restore(ckpt)
    dev = torch.device(device)
    model = detr.build_detr(closed_scene.make_detr(), flax_params=params, device=dev)
    img, _ = closed_scene.render(closed_scene.ring_pose(segment_eval.HELD_OUT_PHI))
    with torch.no_grad():
        out = model(torch.from_numpy(closed_scene.norm(img))[None].to(dev))
    return {k: out[k].float().cpu() for k in DETR_HEADS if k in out}


def examples_cpu_reference(steps: int, out_path: str) -> None:
    """The examples phase's CPU references, run in a process of their own
    while the card runs the phase: ``train_associator_synthetic`` for
    ``steps`` steps and ``probe_detector`` on the committed weights; their
    numbers as JSON in ``out_path``."""
    from odam_torch.examples import train_associator_synthetic as tas
    from odam_torch.examples.cli_rehearsal import probe_detector

    torch.set_num_threads(EXAMPLE_CPU_THREADS)
    r = tas.run("cpu", steps=steps, verbose=False)
    counts = probe_detector.probe(device="cpu")
    with open(out_path, "w") as f:
        json.dump({"before": r["before"], "after": r["after"], "nll": r["nll"],
                   "train_seconds": r["train_seconds"],
                   "probe": {k: list(v) for k, v in counts.items()}}, f)


def examples_run(device: str = "cuda", out_root: str = EXAMPLES_OUT,
                 work: str = EXAMPLES_WORK, depth: dict | None = None) -> tuple[dict, dict]:
    """The example scripts of ``odam_torch/examples`` in-process at
    ``EXAMPLE_DEPTH``, each script's launches by kernel and dtype counted
    (module docstring, phase 23).  The trainers run on the plain attention
    path; the closed-loop evaluation and the probe run the detector with the
    kernels, the associator's evaluation the GNN's kernels and the LAP.
    ``train.py``'s detector and associator modes run on the hard split (the
    committed checkpoints' recipe), its frozen mode on the standard split,
    whose feature cache is 19 MB (the hard split's would be 0.75 GB).
    The CPU references (the associator's 400 steps and the probe) run in a
    process of their own beside the card's work.  Returns (report, launches
    by path)."""
    from odam_torch.examples import fit_superquadric, synthetic_mapping
    from odam_torch.examples import train_associator_synthetic as tas
    from odam_torch.examples.cli_rehearsal import make_dataset, probe_detector
    from odam_torch.examples.cli_rehearsal import train as rehearsal_train
    from odam_torch.examples.closed_loop import segment_eval, segment_train
    from odam_torch.ops import kernels
    from odam_torch.utils.metrics import device_banner

    d = {**EXAMPLE_DEPTH, **(depth or {})}
    on_card = torch.device(device).type == "cuda"
    report = {"phase": "examples", "device": device_banner(torch.device(device)), "depth": d,
              "scripts": {}}
    paths = {}
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # the CPU references run beside the card's work, in a process of their own
    cpu_out = os.path.abspath(os.path.join(work, "cpu_reference.json"))
    with open(os.path.join(work, "cpu_reference.log"), "w") as log:
        cpu_proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.examples_cpu_reference("
                                   f"{d['assoc_steps']}, {cpu_out!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)

    try:
        def run(name, fn):
            _reset_counts()
            t0 = time.perf_counter()
            out = fn()
            paths[f"examples:{name}"] = _launches(on_card)
            by_dtype = kernels.counts("LAUNCHES_BY_DTYPE" if on_card else "PLAIN_CALLS_BY_DTYPE")
            report["scripts"][name] = {
                "seconds": time.perf_counter() - t0, "launches": paths[f"examples:{name}"],
                "launches_by_dtype": {k: {dt: n for dt, n in v.items() if n}
                                      for k, v in by_dtype.items()}}
            return out

        # 1. synthetic_mapping at full depth: the drive recipe's bars
        sm = run("synthetic_mapping", lambda: synthetic_mapping.run(
            device, n_iters=d["map_iters"], verbose=False))
        drop = float(sm["loss_log"][0] / sm["loss_log"][-1])
        if not (drop > MAP_LOSS_DROP and np.mean(sm["ious"]) > MAP_MEAN_IOU and sm["n_merged"] == 2):
            raise AssertionError(f"synthetic_mapping: loss drop {drop:.2f}, IoUs {sm['ious']}, "
                                 f"{sm['n_merged']} tracks after the merge")
        report["scripts"]["synthetic_mapping"].update(
            loss_first=float(sm["loss_log"][0]), loss_last=float(sm["loss_log"][-1]),
            loss_drop=drop, ious=sm["ious"], n_merged=sm["n_merged"],
            solve_seconds=sm["solve_seconds"])

        # 2. fit_superquadric's fit (write_artifacts, matplotlib, is held on the CPU by the tests)
        gt = fit_superquadric.ground_truth(0)
        _, _, losses, params, _ = run("fit_superquadric", lambda: fit_superquadric.fit(
            *gt, d["fit_iters"], device=device))
        if not (np.isfinite(losses).all() and losses[-1] < FIT_L1_MAX):
            raise AssertionError(f"fit_superquadric: L1 {losses[0]:.4f} -> {losses[-1]:.4g}")
        report["scripts"]["fit_superquadric"].update(
            iters=d["fit_iters"], loss_first=float(losses[0]), loss_final=float(losses[-1]),
            pos_err=float(np.linalg.norm(params["pos"] - gt[0])))

        # 3. train_associator_synthetic on the card (its CPU reference: after step 7)
        card = run("train_associator_synthetic", lambda: tas.run(
            device, steps=d["assoc_steps"], verbose=False))
        if on_card and not paths["examples:train_associator_synthetic"]["lap_solve"]:
            raise AssertionError("lap_solve was never launched by the associator's evaluation")

        # 4. the closed loop: a segment, resumed, then the evaluation
        ckpt = os.path.join(work, "closed_loop_ckpt")
        segs = [run(f"closed_loop_train_seg{seg}", lambda seg=seg: segment_train.segment_train(
            seg, d["loop_steps"], ckpt, device)) for seg in (0, 1)]
        if segs[1]["global_step"] != 2 * d["loop_steps"]:
            raise AssertionError(f"closed loop: global step {segs[1]['global_step']}")
        ev = run("closed_loop_eval", lambda: segment_eval.segment_eval(ckpt, device, verbose=False))
        report["scripts"]["closed_loop_eval"].update(
            result=ev, losses=[s["loss"] for s in segs], train_seconds=[s["seconds"] for s in segs])
        if on_card and not paths["examples:closed_loop_eval"]["fused_attention"]:
            raise AssertionError("fused_attention was never launched on the closed-loop eval")
        # the evaluation's held-out view: the raw heads against the CPU's on the checkpoint
        card_heads, cpu_heads = (_held_out_heads(ckpt, dev) for dev in (device, "cpu"))
        head_err = {}
        for k, c in cpu_heads.items():
            g = card_heads[k]
            if not (torch.isfinite(g).all() and torch.allclose(g, c, atol=DETR_ATOL,
                                                               rtol=DETR_RTOL)):
                raise AssertionError(f"closed loop held-out {k}: card vs CPU max|diff| "
                                     f"{float((g - c).abs().max()):.3e}")
            head_err[k] = float((g - c).abs().max())
        report["scripts"]["closed_loop_eval"]["held_out_heads"] = {
            "max_abs_err": head_err, "tol": {"atol": DETR_ATOL, "rtol": DETR_RTOL}}

        # 5. make_dataset --hard
        data = os.path.join(out_root, "data_hard")
        shutil.rmtree(data, ignore_errors=True)
        run("make_dataset", lambda: make_dataset.main_cli([data, "--hard"]))
        n_jpg = sum(f.endswith(".jpg") for _, _, fs in os.walk(data) for f in fs)
        if n_jpg != 3 * 32:
            raise AssertionError(f"make_dataset --hard wrote {n_jpg} frames, not 96")
        report["scripts"]["make_dataset"]["frames"] = n_jpg

        # 6. the rehearsal trainer, each mode
        for mode, hard in (("detector", "1"), ("detector_frozen", "0"), ("associator", "1")):
            env = {"ODAM_HARD": hard, "ODAM_TRAIN_BATCH": str(d["train_batch"]), "ODAM_BANK": "10"}
            out = run(f"train_{mode}", lambda mode=mode, env=env: _with_env(
                env, lambda: rehearsal_train.main([mode, "0", str(d["train_steps"]),
                                                   os.path.join(work, f"train_{mode}"),
                                                   "--device", device])))
            if not np.isfinite(out["loss"]):
                raise AssertionError(f"train.py {mode}: loss {out['loss']}")
            report["scripts"][f"train_{mode}"].update(out, hard=hard == "1")

        # 7. probe_detector on the card
        counts = run("probe_detector", lambda: {
            k: list(v) for k, v in probe_detector.probe(device=device).items()})
        report["scripts"]["probe_detector"]["counts"] = counts
        if on_card and not paths["examples:probe_detector"]["fused_attention"]:
            raise AssertionError("fused_attention was never launched by probe_detector")

        # the CPU references: the associator's F1 and the probe's counts
        t0 = time.perf_counter()
        if cpu_proc.wait() != 0:
            with open(os.path.join(work, "cpu_reference.log")) as f:
                raise AssertionError(f"examples' CPU references failed: {f.read()[-3000:]}")
        report["cpu_reference_wait_s"] = time.perf_counter() - t0
        with open(cpu_out) as f:
            cpu = json.load(f)
        f1 = {dev: {"before": r["before"]["f1"], **{k: v["f1"] for k, v in r["after"].items()}}
              for dev, r in (("card", card), ("cpu", cpu))}
        after = [k for k in f1["card"] if k != "before"]
        if not (f1["card"]["before"] == f1["cpu"]["before"]
                and all(abs(f1["card"][k] - f1["cpu"][k]) <= EXAMPLE_F1_ATOL for k in after)
                and np.mean([f1["card"][k] for k in after]) > f1["card"]["before"]):
            raise AssertionError(f"train_associator_synthetic: F1 {f1}")
        report["scripts"]["train_associator_synthetic"].update(
            f1=f1, f1_atol=EXAMPLE_F1_ATOL, nll={"card": card["nll"], "cpu": cpu["nll"]},
            train_seconds={"card": card["train_seconds"], "cpu": cpu["train_seconds"]})
        if counts != cpu["probe"]:
            raise AssertionError(f"probe_detector: card {counts} against CPU {cpu['probe']}")
    finally:
        if cpu_proc.poll() is None:      # a failure above: stop the references
            cpu_proc.kill()
            cpu_proc.wait()
    shutil.rmtree(work, ignore_errors=True)
    return report, paths


STUDIES_OUT = os.path.join("chiprun_out", "studies")
STUDIES_FRAMES = 16           # the ablation's split: one hard scene (seed 0) of 16 frames
STUDIES_BOOT = 1000           # bootstrap draws of the phase's scoring (the scripts' 10000)
STUDIES_FT_STEPS = 3          # window_experiment's fine-tune at window 400 (the script's 1200)
STUDIES_STREAM_FRAMES = 160   # the fine-tune's training streams (the script's 480)
STUDIES_CHILD_THREADS = "2"   # OMP_NUM_THREADS of the scripts' child processes
STUDIES_CPU_THREADS = 2       # the CPU references' process, beside the card's
STUDIES_IOU_ATOL = 0.02       # card vs CPU IoUs with the ground truth (read: 0.0053, 0.0076)
STUDIES_MIN_VIEWS = 6         # the cells' and the window arm's bar: at 10, 16 frames give F1 0
STUDIES_NLL_ATOL = 1e-4       # validate's NLL, card vs CPU
STUDIES_SEED = 0              # diagnose_recall's layout seed; run_stage's rng is 7000 + seed


def studies_cpu_reference(out_path: str) -> None:
    """The studies phase's CPU references, run in a process of their own
    beside the card's work: ``diagnose_recall``'s oracle_det tracking on
    STUDIES_SEED and ``validate`` on the committed weights, pickled to
    ``out_path``."""
    import pickle

    from odam_torch.artifacts import validate
    from odam_torch.examples.cli_rehearsal import common, diagnose_recall, hard

    torch.set_num_threads(STUDIES_CPU_THREADS)
    t0 = time.perf_counter()
    pipe = diagnose_recall.build_pipeline(common.ASSOC_WEIGHTS, "exact", "cpu")
    pipe.init_sequence(hard.K, hard.IMG, hard.IMG)
    tracks = diagnose_recall.oracle_tracks(pipe, STUDIES_SEED, 0.02,
                                           np.random.default_rng(7000 + STUDIES_SEED))
    t1 = time.perf_counter()
    val = validate.main(["--device", "cpu"])
    with open(out_path, "wb") as f:
        pickle.dump({"tracks": tracks, "validate": val,
                     "seconds": {"diagnose_recall": t1 - t0,
                                 "validate": time.perf_counter() - t1}}, f)


def _retrain_first_segments(out_root: str, device: str) -> list[str]:
    """``odam_torch/artifacts/retrain.sh --out <out_root>/out`` as far as its
    segment logic: a stub ``python`` first on ``PATH`` logs every call and
    runs the real interpreter only for the meta heredoc (``python -``), on a
    stub detector checkpoint at global step 3000.  Returns the logged
    trainer calls."""
    from odam_torch.utils import checkpoint

    stub, log, out = (os.path.join(out_root, p) for p in ("bin", "calls.log", "out"))
    os.makedirs(stub)
    with open(os.path.join(stub, "python"), "w") as f:
        f.write(f'#!/bin/sh\necho "$*" >> "{log}"\n'
                f'if [ "$1" = "-" ]; then exec "{sys.executable}" "$@"; fi\nexit 0\n')
    os.chmod(os.path.join(stub, "python"), 0o755)
    tiny = {"x": np.zeros(1, np.float32)}
    checkpoint.save(os.path.join(out, "rehearsal_hard_assoc_ckpt"), tiny, meta={"global_step": 800})
    checkpoint.save(os.path.join(out, "rehearsal_hard_detr_ckpt"), tiny,
                    meta={"global_step": 3000, "seg": 1, "seg_steps": 1500})
    proc = subprocess.run(["bash", os.path.join("odam_torch", "artifacts", "retrain.sh"),
                           "--out", out, "--device", device], capture_output=True, text=True,
                          env=dict(os.environ, PATH=stub + os.pathsep + os.environ["PATH"]),
                          timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"retrain.sh failed: {proc.stderr[-2000:]}")
    with open(log) as f:
        return [c for c in f.read().splitlines() if not c.startswith("- ")]


def _rows_differ(a: dict, b: dict) -> bool:
    """Whether two results' tracks differ in any shape or row."""
    return len(a["tracks"]) != len(b["tracks"]) or any(
        x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(a["tracks"], b["tracks"]))


def studies_run(scene_f1: dict, out_root: str = STUDIES_OUT,
                scene_root: str = os.path.join("chiprun_out", "scene"),
                devices: tuple[str, str] = ("cuda", "cpu"), frames: int = STUDIES_FRAMES,
                ft_steps: int = STUDIES_FT_STEPS, stream_frames: int = STUDIES_STREAM_FRAMES,
                boot: int = STUDIES_BOOT) -> tuple[dict, dict]:
    """The rehearsal studies of ``odam_torch/examples/cli_rehearsal`` and the
    artifact tools of ``odam_torch/artifacts``, each run at least once on the
    card (module docstring, phase 24).  Threads run what lives in child
    processes beside the in-process work, on a one-scene split of
    ``frames`` frames: ``tune_threshold`` at the reference's operating
    point, ablate's baseline cell (linked under that name), and
    ``ablate.run_config`` for the ``stale_track_bbox`` fault; ``window_experiment``'s
    ``finetune`` at window 400 for ``ft_steps`` steps on ``stream_frames``-
    frame streams, then ``run_arm``; ``retrain.sh`` as far as its segment
    logic; the CPU references (:func:`studies_cpu_reference`).  In this
    process, in order: ``ci_eval``, ``tune_min_views`` and ``audit_misses``
    score the scene phase's card and CPU results (``scene_root``): counts,
    F1 and modes equal, F1 the scene phase's, IoUs with the ground truth
    within STUDIES_IOU_ATOL (the scene phase holds card against CPU boxes to
    IoU SCENE_QC_IOU, not to equality); ``diagnose_recall``'s three stages
    on STUDIES_SEED (side by side) and its oracle_det tracking, then
    ``validate``, each with its launches counted: fused_attention (and for
    diagnose_recall lap_solve) launched, no plain or host call on the card;
    their results against the CPU's.  Then ``ablate_big.score`` pairs the
    two cells, whose track rows must differ and whose F1 at
    STUDIES_MIN_VIEWS must drop with the fault; the window arm's F1 there
    must be above 0.  Returns (report, launches by path)."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    from odam_torch.artifacts import validate
    from odam_torch.examples.cli_rehearsal import (ablate, ablate_big, audit_misses, ci_eval,
                                                   common, diagnose_recall, hard, make_dataset,
                                                   tune_min_views, tune_threshold,
                                                   window_experiment)
    from odam_torch.utils.metrics import device_banner

    card, cpu = devices
    dev = torch.device(card)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    report = {"phase": "studies", "device": device_banner(dev), "seconds_by_module": {},
              "depth": {"frames": frames, "ft_steps": ft_steps, "stream_frames": stream_frames,
                        "boot": boot}}
    seconds = report["seconds_by_module"]
    paths = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    shutil.rmtree(out_root, ignore_errors=True)
    out_root = os.path.abspath(out_root)
    data = os.path.join(out_root, "data")
    make_dataset.main_hard(data, seeds=(STUDIES_SEED,), n_frames=frames)
    ckpts = (common.DETR_WEIGHTS, common.ASSOC_WEIGHTS)
    cells = os.path.join(out_root, "ablate")
    names = ("adam_exact_sampled", "FAULT_stale_track_bbox")

    def baseline():       # the reference's operating point is ablate's baseline
        sweep = timed("tune_threshold", tune_threshold.main, [
            "--data", data, "--out", cells, "--thresholds", "0.6", "--attach", "0.8",
            "--device", card, "--detector_ckpt", ckpts[0], "--associator_ckpt", ckpts[1]])
        os.symlink(sweep[0]["name"], os.path.join(cells, names[0]))
        return sweep

    def fault():
        return timed("ablate", ablate.run_config, data, cells, names[1],
                     *ablate_big.EVAL_CELLS[names[1]], ckpts, card)

    def window():
        ck = os.path.join(out_root, "window", "assoc_w400_long_ckpt")
        losses = timed("window_experiment", window_experiment.finetune, 400, ckpts[1], ck,
                       ft_steps, card)
        arm = timed("window_experiment", window_experiment.run_arm, data,
                    os.path.join(out_root, "window"), 400, ck, ckpts[0], STUDIES_MIN_VIEWS, card)
        return losses, arm

    def cpu_reference():
        out = os.path.join(out_root, "cpu_reference.pkl")
        with open(os.path.join(out_root, "cpu_reference.log"), "w") as log:
            proc = subprocess.run(
                [sys.executable, "-c",
                 f"import chip_smoke; chip_smoke.studies_cpu_reference({out!r})"],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            with open(os.path.join(out_root, "cpu_reference.log")) as f:
                raise AssertionError(f"studies' CPU references failed: {f.read()[-3000:]}")
        with open(out, "rb") as f:
            return pickle.load(f)

    stream = window_experiment.STREAM_FRAMES
    window_experiment.STREAM_FRAMES = stream_frames
    try:
        with ThreadPoolExecutor(5) as pool, _env_set({"OMP_NUM_THREADS": STUDIES_CHILD_THREADS}):
            futures = {"baseline": pool.submit(baseline), "fault": pool.submit(fault),
                       "window": pool.submit(window),
                       "retrain": pool.submit(timed, "retrain.sh", _retrain_first_segments,
                                              os.path.join(out_root, "retrain"), card),
                       "cpu": pool.submit(timed, "cpu_references", cpu_reference)}

            # 1. scoring of the scene phase's results, card and CPU
            scores = {}
            for d in dict.fromkeys(devices):
                result_dir = os.path.join(scene_root, d)
                table = timed("ci_eval", ci_eval.scene_table, result_dir, SCENE_DATA)
                scores[d] = {
                    "table": table, "ci": timed("ci_eval", ci_eval.bootstrap_ci, table, boot),
                    "min_views": [timed("tune_min_views", tune_min_views.score, result_dir,
                                        SCENE_DATA, mv) for mv in (4, 6, 8, 10)],
                    "audit": [row for seed in hard.EVAL_SEEDS for row in timed(
                        "audit_misses", audit_misses.audit_scene, seed, result_dir)[0]]}

            # 2. diagnose_recall: the stages side by side on the card (each ends in an
            # eval_scan2cad process; only oracle_det launches kernels), then
            # oracle_det's tracking alone
            def diagnose():
                with ThreadPoolExecutor(3) as stage_pool:
                    stages = list(stage_pool.map(
                        lambda stage: diagnose_recall.run_stage(
                            stage, os.path.join(out_root, "diagnose"), 0.02, ckpts[1], "exact",
                            card, (STUDIES_SEED,)),
                        ("gt_full", "gt_visible", "oracle_det")))
                pipe = diagnose_recall.build_pipeline(ckpts[1], "exact", card)
                pipe.init_sequence(hard.K, hard.IMG, hard.IMG)
                return stages, diagnose_recall.oracle_tracks(
                    pipe, STUDIES_SEED, 0.02, np.random.default_rng(7000 + STUDIES_SEED))

            plain_before = _launches(False)
            (stages, tracks), diag_calls, diag_dtype = timed("diagnose_recall", _counted, dev,
                                                             diagnose)
            diag_plain = {k: n - plain_before[k] for k, n in _launches(False).items()}

            # 3. validate on the committed weights
            plain_before = _launches(False)
            val_card, val_calls, val_dtype = timed("validate", _counted, dev, validate.main,
                                                   ["--device", card])
            val_plain = {k: n - plain_before[k] for k, n in _launches(False).items()}
            results = {k: f.result() for k, f in futures.items()}
    finally:
        window_experiment.STREAM_FRAMES = stream

    g, c = scores[card], scores[cpu]
    iou_diff = max([float(np.abs(a - b).max()) for a, b in zip(g["table"]["obj_ious"],
                                                               c["table"]["obj_ious"])]
                   + [abs(a[k] - b[k]) for a, b in zip(g["audit"], c["audit"])
                      for k in a if k.endswith("iou")], default=0.0)
    counted = ("precision", "recall", "f1", "n_gt", "n_pred", "n_tp", "f1_ci", "recall_ci",
               "precision_ci")
    if not (np.array_equal(g["table"]["counts"], c["table"]["counts"])
            and all(g["ci"][k] == c["ci"][k] for k in counted)
            and g["min_views"] == c["min_views"]
            and [(r["gt"], r["mode"], r.get("blame")) for r in g["audit"]]
            == [(r["gt"], r["mode"], r.get("blame")) for r in c["audit"]]
            and iou_diff <= STUDIES_IOU_ATOL):
        raise AssertionError(f"studies: card and CPU scoring differ (IoU {iou_diff:.3e}): "
                             f"{g['ci']} {c['ci']} {g['min_views']} {c['min_views']}")
    if abs(g["ci"]["f1"] - scene_f1["average"]["f1"]) > 1e-12 or \
            g["min_views"][-1]["f1"] != round(scene_f1["average"]["f1"], 4):
        raise AssertionError(f"studies: F1 {g['ci']['f1']} is not the scene phase's "
                             f"{scene_f1['average']['f1']}")
    modes = [r["mode"] for r in g["audit"]]
    report["scoring"] = {
        "ci": g["ci"], "min_views": g["min_views"], "card_equals_cpu": True,
        "max_iou_diff_card_vs_cpu": iou_diff, "iou_atol": STUDIES_IOU_ATOL,
        "audit_modes": {m: modes.count(m) for m in sorted(set(modes))},
        "audit_blames": [r["blame"] for r in g["audit"] if "blame" in r]}

    ref = results["cpu"]
    seconds["cpu_references_by_part"] = ref["seconds"]
    paths["studies:diagnose_recall"] = diag_calls
    paths["studies:validate"] = val_calls
    if on_card and not (diag_calls["fused_attention"] and diag_calls["lap_solve"]
                        and not any(diag_plain.values())):
        raise AssertionError(f"diagnose_recall: launches {diag_calls}, plain calls {diag_plain}")
    if on_card and not (val_calls["fused_attention"] and not any(val_plain.values())):
        raise AssertionError(f"validate: launches {val_calls}, plain calls {val_plain}")
    cpu_tracks = ref["tracks"]
    row_diff = max((float(np.abs(a - b).max()) for a, b in zip(tracks, cpu_tracks)
                    if a.shape == b.shape), default=0.0)
    if not ([t[:, :2].tolist() for t in tracks] == [t[:, :2].tolist() for t in cpu_tracks]
            and row_diff <= SCENE_ROW_ATOL):
        raise AssertionError(f"diagnose_recall oracle_det: card tracks {[len(t) for t in tracks]}"
                             f" against the CPU's {[len(t) for t in cpu_tracks]}, rows "
                             f"{row_diff:.3e}")
    report["diagnose_recall"] = {
        "seed": STUDIES_SEED, "stages": stages, "oracle_det_tracks": [len(t) for t in tracks],
        "card_vs_cpu": {"ids_equal": True, "max_row_abs_diff": row_diff, "atol": SCENE_ROW_ATOL},
        "launches": diag_calls, "launches_by_dtype": diag_dtype, "plain_calls_on_card": diag_plain}
    val_cpu = ref["validate"]
    nll_diff = abs(val_card["associator_nll"] - val_cpu["associator_nll"])
    if not (nll_diff <= STUDIES_NLL_ATOL and val_card["detector"] == val_cpu["detector"]):
        raise AssertionError(f"validate: card {val_card} against CPU {val_cpu}")
    report["validate"] = {"card": val_card, "cpu": val_cpu, "nll_diff": nll_diff,
                          "nll_atol": STUDIES_NLL_ATOL, "launches": val_calls,
                          "launches_by_dtype": val_dtype, "plain_calls_on_card": val_plain}

    retrain_want = [f"-m odam_torch.examples.cli_rehearsal.train detector {s} 1500 "
                    f"{os.path.join(out_root, 'retrain', 'out', 'rehearsal_hard_detr_ckpt')} "
                    f"--device {card}" for s in range(2, 12)]
    if results["retrain"] != retrain_want:
        raise AssertionError(f"retrain.sh: {results['retrain']}")
    report["retrain_sh"] = {"stub_global_step": 3000, "segments": list(range(2, 12))}

    # the threads' scripts: the fault reached its child and costs F1; ablate_big's decision
    sweep, fault = results["baseline"], results["fault"]
    pickles = {}
    for name in names:
        scene = hard.hard_scene_id(STUDIES_SEED)
        with open(os.path.join(cells, name, scene, scene), "rb") as f:
            pickles[name] = pickle.load(f)
    if not _rows_differ(*pickles.values()):
        raise AssertionError("ablate: the stale_track_bbox cell's tracks equal the baseline's")
    big = timed("ablate_big", ablate_big.score, data, cells, list(names), boot=boot)
    (decision,) = big["decisions"]
    f1_mv = {name: big["eval"][f"{name}_mv{STUDIES_MIN_VIEWS}"]["f1"] for name in names}
    if not f1_mv[names[1]] < f1_mv[names[0]]:
        raise AssertionError(f"ablate: at min_views {STUDIES_MIN_VIEWS} the fault's F1 "
                             f"{f1_mv[names[1]]} is not below the baseline's {f1_mv[names[0]]}")
    losses, arm = results["window"]
    if not (losses == [] and arm["tracks"] > 0 and arm["f1"] > 0):
        raise AssertionError(f"window_experiment: banked losses {losses}, arm {arm}")
    report.update(
        ablate={"cells": [sweep[0], fault], "baseline": f"{sweep[0]['name']}, linked as {names[0]}",
                "fault_rows_differ": True, f"f1_min_views_{STUDIES_MIN_VIEWS}": f1_mv,
                "fault_lowers_f1": True},
        tune_threshold=sweep, ablate_big={"decision": decision},
        window_experiment={"arm": arm, "banked_losses": losses,
                           "note": "JAX's quirk: the trainer prints nll, the check parses loss"},
        seconds=time.perf_counter() - t_phase)
    return report, paths


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
    msda_rows = msda_checks()
    emit({"phase": "msda_checks", "cases": len(msda_rows), "all_within_tolerance": True,
          "bf16_locations_fail_the_bar": True,
          "device_ms": {f"{r['case']} {r['dtype']}": r["ms"] for r in msda_rows},
          "plain_ms": {f"{r['case']} {r['dtype']}": r["plain_ms"] for r in msda_rows}})
    kernel_rows += msda_rows
    sinkhorn_report, sinkhorn_rows = sinkhorn_checks()
    emit(sinkhorn_report)
    kernel_rows += sinkhorn_rows
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
    for path in ("slice", "slice_bf16"):      # every kernel of the DETR step
        for name, n in paths[path].items():
            if n == 0 and name != "ms_deform_attn":
                raise AssertionError(f"{name} was never launched on the {path} path")
    deformable_report, deformable_paths = deformable_lanes_run()
    emit(deformable_report)
    paths.update(deformable_paths)
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
    emit(cli_dist_run())
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
    tools_report, tools_paths, attn_rows = tools_run()
    emit(tools_report)
    paths.update(tools_paths)
    for tool in ("profile_pipeline", "ab_step_input", "bench_scene_parallel",
                 "bench_batched_detection"):
        for name in ("flash_attention", "fused_attention"):
            if paths[f"tools:{tool}"][name] == 0:
                raise AssertionError(f"{name} was never launched by {tool}")
    examples_report, examples_paths = examples_run()
    emit(examples_report)
    paths.update(examples_paths)
    studies_report, studies_paths = studies_run(scene_report["f1"])
    emit(studies_report)
    paths.update(studies_paths)
    for path in ("offline", "scene_parallel_full", "scene_parallel_full_bf16", "scene",
                 "scene_parallel_hard", "cli_scene_parallel", "cli_full", "cli_offline",
                 "train_detector", "eval_association"):     # cli_fast decodes greedily
        if not paths[path].get("lap_solve"):
            raise AssertionError(f"lap_solve was never launched on the {path} path")
    for path in ("slice", "slice_bf16", "offline", "scene_parallel_full",
                 "scene_parallel_full_bf16", "deformable_lanes", "deformable_lanes_bf16",
                 "scene", "scene_parallel_hard", "cli_scene_parallel", "cli_full", "cli_fast",
                 "cli_offline", "train_cli", "dist_nccl_rank0", "dist_gloo2_rank0",
                 "dist_gloo2_rank1", "eval_association", "tools:profile_pipeline",
                 "tools:ab_step_input", "tools:bench_scene_parallel",
                 "examples:train_associator_synthetic", "studies:diagnose_recall",
                 "studies:validate"):     # every path that associates on the card
        if not paths[path].get("sinkhorn"):
            raise AssertionError(f"the Sinkhorn kernel was never launched on the {path} path")
    tool_launches = {(r["case"], r["dtype"], f"{col}_attention"): r[f"{col}_launches"]
                     for r in attn_rows for col in ("fused", "flash")}
    for path, counts in paths.items():      # no DETR path samples a level
        if counts["ms_deform_attn"] and not path.startswith("deformable_lanes"):
            raise AssertionError(f"the MSDA kernel launched on the {path} path: {counts}")
    for row in kernel_rows:
        if not row["ms"] > row["bound_ms"]:
            raise AssertionError(f"{row['name']} {row.get('case')}: {row['ms']} ms at or "
                                 f"below its bound {row['bound_ms']} ms")
        if row["path"] == "bench_attention":      # bench_attention's launches at this case
            row["launches"] = tool_launches[(row["case"].split(": ")[1], row["dtype"],
                                             row["name"])]
        elif row["path"] == "lanes":      # the lane step's launches at this B
            row["launches"] = sp_full_report["launches_by_batch"][row["dtype"]][row["name"]].get(
                row["shape"]["B"], 0)
        elif str(row["path"]).startswith("examples:"):    # the launches of that example's run
            row["launches"] = paths[row["path"]][row["name"]]
        elif row["path"] == "scene_parallel_full":     # the f32 lane steps' (one a step)
            row["launches"] = paths["scene_parallel_full"][row["name"]]
        elif row["path"] == "deformable_lanes":     # the deformable lane step's, this dtype
            row["launches"] = paths["deformable_lanes" if row["dtype"] == "float32"
                                    else "deformable_lanes_bf16"][row["name"]]
        else:
            main_path = "slice" if row["dtype"] == "float32" else "slice_bf16"
            row["launches"] = paths[main_path][row["name"]]
            if row["name"] == "lap_solve":       # the slice's LAP launches on this row's route
                row["route_launches"] = slice_report["lap_route_launches"][row["lap_route"]]
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
