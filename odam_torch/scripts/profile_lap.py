"""Where the exact LAP kernel's time goes on the card.

    python -m odam_torch.scripts.profile_lap [--out PATH] [--sass PATH]

Builds ``odam_torch/csrc/lap.cu`` as the port builds it (the kernel seam's
``LAP`` library), and once more with ``-DODAM_LAP_CLOCK``, a variant of it
whose kernels add ``clock64()`` stamps by part.  It runs the LAP cases of ``chip_smoke.py``'s ``lap`` phase (the same
seeded inputs, :func:`lap_cases`) on every route of the library that takes
the case:

  registers  the kernel that ``lap.solve`` launches for C <= 256 (each
             lane's columns in registers, the cost staged in shared memory)
  shared     the first kernel (all state in shared memory), the route for
             wider problems

For each case and route: device ms a launch (20 launches in a CUDA graph,
replayed), the plain solver's sweeps (Dijkstra steps) and augmentation
steps of the slowest problem, ns a sweep (ms over those sweeps), and
problem 0's cycles by part from the clock build: init (state and staging),
columns (cost loads, relaxation, each lane's least), pick (the warp's
reduction), next (the next row and its potential), row (dual update and
augmentation).  Also ptxas' registers and spills of the port's build and
the SASS opcode counts of each kernel (``cuobjdump -sass``; ``--sass``
writes the listing).  Prints one JSON object and returns it.  Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from .. import resolve_device
from ..ops import kernels, lap

CLOCK_PARTS = ("init", "columns", "pick", "next", "row")     # lap.cu's kClk* order
CLOCK_SLOTS = len(CLOCK_PARTS) + 3                            # + total, sweeps, rows
OPCODES = ("LDG", "LDS", "STS", "LDGSTS", "SHFL", "REDUX", "WARPSYNC", "BAR", "BRA", "CS2R")


def lap_cases(rng: np.random.Generator, threshold: float) -> list[tuple[str, torch.Tensor]]:
    """The solver's inputs [S, R, C] on the main paths, at the edges and at
    the routes' boundaries, drawn from ``rng`` in a fixed order."""
    def captured(fn, *args) -> torch.Tensor:
        seen, real = [], lap.solve
        lap.solve = lambda cost: seen.append(cost) or real(cost)
        try:
            fn(*args)
        finally:
            lap.solve = real
        return seen[0].reshape(-1, *seen[0].shape[-2:]).contiguous()

    def decode(B, n_tracks=48, n_dets=26, T=64, N=30):
        score = torch.from_numpy(rng.random((B, T, N)).astype(np.float32))
        rm, cm = torch.zeros(B, T, dtype=torch.bool), torch.zeros(B, N, dtype=torch.bool)
        rm[:, :n_tracks], cm[:, :n_dets] = True, True
        return captured(lap.match_by_score, score, threshold, rm, cm)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    S, B, Q, M = 6, 8, 100, 8           # train_detector: 6 decoder layers x batch 8
    cost = torch.from_numpy((rng.normal(size=(S, B, Q, M)) * 3).astype(np.float32))
    tmask = torch.from_numpy(rng.random((B, M)) < 0.6)
    match = captured(lap.masked_assignment, cost, torch.ones(S, B, Q, dtype=torch.bool),
                     tmask.expand(S, B, M))
    return [
        ("decode B=1 (48 tracks x 26 detections of 64 x 30)", decode(1)),
        ("decode B=8 (lanes P=8)", decode(8)),
        ("matcher (6 layers x 8 images, 100 queries x 8 targets)", match),
        ("tie-heavy integer costs 0..3", torch.from_numpy(
            rng.integers(0, 4, size=(16, 30, 64)).astype(np.float32))),
        ("all-masked decode", decode(4, n_tracks=0, n_dets=0)),
        ("256 x 256", normal(1, 256, 256)),
        ("K=1, every lane one column: 32 x 32", normal(8, 32, 32)),
        ("K=2, one lane two columns: ties 0..2 at 33 x 33", torch.from_numpy(
            rng.integers(0, 3, size=(4, 33, 33)).astype(np.float32))),
        ("K=8, one lane eight columns: 100 x 129", normal(2, 100, 129)),
        ("largest staged problem: 227 x 256", normal(1, 227, 256)),
        ("shared route: 48 x 257", normal(2, 48, 257)),
    ]


def plain_stats(cost: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The plain solver on each problem of [S, R, C]: col4row [S, R] and the
    sweeps and augmentation steps of the slowest problem and of all."""
    outs, per = [], []
    for c in cost:
        st: dict = {}
        outs.append(lap._solve_square_leq(c, st))
        per.append(st)
    return torch.stack(outs), {
        "sweeps": max(p["sweeps"] for p in per),
        "augment_steps": max(p["augment_steps"] for p in per),
        "sweeps_all": sum(p["sweeps"] for p in per),
        "augment_steps_all": sum(p["augment_steps"] for p in per)}


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device ms a call: ``calls`` calls in one CUDA graph, replayed."""
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


def launcher(lib: kernels.Library, route: str, cost: torch.Tensor, out: torch.Tensor):
    """A call that launches ``route``'s kernel of ``lib`` on [S, R, C] into
    ``out`` (uncounted; it raises if the launch fails), or None if the route
    does not take the shape."""
    S, R, C = cost.shape
    args = (cost.data_ptr(), out.data_ptr(), S, R, C, R * C)
    if route == "shared":
        if lap.smem_bytes(R, C) > lap.SMEM_LIMIT:
            return None
        return lambda: lib.call("odam_lap_solve", *args, device=cost.device)
    p = lap.plan(R, C)
    if p.route != "registers":
        return None
    return lambda: lib.call("odam_lap_solve_regs", *args, p.K, p.staged_rows, device=cost.device)


def sass_counts(library: str, listing: str | None) -> dict:
    """Opcode counts of each kernel in the library's SASS."""
    exe = shutil.which("cuobjdump") or os.path.join(os.path.dirname(kernels.nvcc_path()),
                                                    "cuobjdump")
    text = subprocess.run([exe, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    if listing:
        os.makedirs(os.path.dirname(os.path.abspath(listing)), exist_ok=True)
        with open(listing, "a") as f:
            f.write(f"// {os.path.basename(library)}\n{text}")
    counts, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if current is not None and m:
            counts[current]["instructions"] += 1
            if m.group(1) in OPCODES:
                counts[current][m.group(1)] += 1
    return {k: dict(v) for k, v in counts.items()}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.profile_lap",
                                 description="Device time and clock64 split of the LAP "
                                             "kernel's routes (PyTorch port).")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--sass", default=None, help="write cuobjdump's SASS listing here")
    ap.add_argument("--seed", type=int, default=9, help="chip_smoke.py's LAP_SEED")
    ap.add_argument("--threshold", type=float, default=0.01,
                    help="the decode's match threshold (chip_smoke's)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device("cuda")
    lib = kernels.LAP
    clock_lib = lib.variant("odam_lap_clock", ("-DODAM_LAP_CLOCK",),
                            {"odam_lap_clock_target": [ctypes.c_void_p]})
    clock = torch.zeros(CLOCK_SLOTS, dtype=torch.int64, device=dev)
    clock_lib.call("odam_lap_clock_target", clock.data_ptr())

    rng = np.random.default_rng(args.seed)
    rows = []
    for label, cost in lap_cases(rng, args.threshold):
        S, R, C = cost.shape
        want, stats = plain_stats(cost)
        gpu = cost.to(dev)
        for route in ("registers", "shared"):
            out = torch.empty((S, R), dtype=torch.int32, device=dev)
            run = launcher(lib, route, gpu, out)
            if run is None:
                continue
            run()
            torch.cuda.synchronize()
            if not torch.equal(out.cpu(), want):
                raise AssertionError(f"{route} {label}: assignments differ from the plain solver")
            ms = graph_ms(run)
            clock.zero_()
            launcher(clock_lib, route, gpu, out)()
            torch.cuda.synchronize()
            cyc = clock.cpu().tolist()
            total, sweeps0, rows0 = cyc[len(CLOCK_PARTS):]
            rows.append({
                "case": label, "route": route, "shape": [S, R, C], "ms": ms, **stats,
                "ns_per_sweep": ms * 1e6 / max(stats["sweeps"], 1),
                "clock": {"cycles": dict(zip(CLOCK_PARTS, cyc)), "total": total,
                          "sweeps": sweeps0, "rows": rows0,
                          "per_sweep": {p: cyc[k] / max(sweeps0, 1)
                                        for k, p in enumerate(CLOCK_PARTS[1:4], 1)},
                          "row_work_per_row": cyc[4] / max(rows0, 1)}})
    report = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
        "ptxas": [ln.strip() for ln in lib.info.get("ptxas", "").splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling" in ln],
        "sass": sass_counts(lib.info["path"], args.sass),
        "rows": rows}
    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
