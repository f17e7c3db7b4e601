"""Readings that the limits of ``correct`` are set from, in one process.

    python3 -m bench_h100.calibrate --workload <cell> --seeds <n>... \
        [--control_seeds <n>...] [--seconds <s>] [--out <file.jsonl>]

For each seed the cell's program is built and driven through a short
window at the cell's own load, and the numbers the check compares are
printed (``"of": "program"``); for each control seed the same with the
reference at the precision one below the configuration's in the
program's place (``"of": "control"``): fp8 operands for the bf16 lanes,
TF32 products for the float32 solve.  One JSON line a reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import manifest, run


def readings(cell_name: str, seeds: list[int], control_seeds: list[int], seconds: float,
             device: torch.device, root=None, pkg=None):
    """Yield one dict a reading."""
    root = manifest.ROOT if root is None else root
    pkg = manifest.PKG if pkg is None else pkg
    bench = manifest.load(root)
    w = manifest.cell(bench, cell_name)
    traffic = manifest.traffic(w["traffic"], pkg)
    config = manifest.config(bench, w["config"], root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in list(dict.fromkeys(seeds + control_seeds)):
        t0 = time.perf_counter()
        mix = manifest.mix(traffic["mix"]).Mix(config, traffic, seed, device)
        mix.setup()
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            mix.unit((time.perf_counter() - w0) / seconds)
        mix.release()
        if seed in seeds:
            c0 = time.perf_counter()
            numbers = mix.check()
            yield {"cell": cell_name, "seed": seed, "of": "program", "numbers": numbers,
                   "units": len(mix.steps), "check_s": time.perf_counter() - c0,
                   "seconds": time.perf_counter() - t0}
        if seed in control_seeds:
            c0 = time.perf_counter()
            numbers = mix.control_check()
            yield {"cell": cell_name, "seed": seed, "of": "control", "numbers": numbers,
                   "check_s": time.perf_counter() - c0, "seconds": time.perf_counter() - t0}
        del mix
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.fix_caches(manifest.ROOT)
    torch.set_num_threads(int(run.HOST_THREADS))
    if not torch.cuda.is_available():
        print("bench_h100.calibrate: no CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, args.seeds, args.control_seeds, args.seconds,
                          torch.device("cuda", 0)):
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    found = run.forbidden_modules()
    if found:
        print(f"bench_h100.calibrate: modules of JAX loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
