"""Run one cell of the benchmark once and print its result line.

    python3 -m bench_h100.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run builds the program and its traffic
from ``--seed`` (set-up: imports, the port's native libraries, weights,
traffic, warm-up of the cell's own shapes), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output.  With ``--trace 1`` a few
units run under ``torch.profiler`` after the window, and the line carries
the cell's per-layer metrics and a ``breakdown`` instead of its end-to-end
ones.  It needs as many CUDA devices as the cell asks for, and exits with
a code other than 0, printing no result, without them, when the check
finds a module of JAX loaded, or when a run cannot finish.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "odam_tpu")
# One process with few threads: the host issues the step from one thread, and
# idle BLAS and OpenMP pools would take cores from it on a shared host.
HOST_THREADS = "1"


def few_threads() -> None:
    """Thread pools of one thread, set before numpy or torch first loads."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
RANGES = ("odam.detr", "odam.postprocess", "odam.track_inputs", "odam.associator",
          "odam.track_update", "bench.step", "bench.readback", "bench.optim", "bench.merge")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fix_caches(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(str(root), ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def evaluate(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and the compared numbers beside their limits: each
    ``max`` limit is an upper bound, each ``min`` one a least count."""
    compared, ok = {}, True
    for name, value in limits.get("max", {}).items():
        got = float(numbers.get(name, math.inf))
        holds = got <= value
        compared[name] = {"value": got if math.isfinite(got) else None, "limit": value,
                          "holds": holds}
        ok &= holds
    for name, value in limits.get("min", {}).items():
        got = numbers.get(name, 0)
        compared[name] = {"value": got, "limit_min": value, "holds": got >= value}
        ok &= got >= value
    return ok, compared


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, root=None,
             pkg=None) -> dict:
    """One run of a cell on ``device``: the result line as a dict."""
    import torch

    from . import manifest
    from . import trace as trace_mod

    root = manifest.ROOT if root is None else root
    pkg = manifest.PKG if pkg is None else pkg
    bench = manifest.load(root)
    w = manifest.cell(bench, cell_name)
    traffic = manifest.traffic(w["traffic"], pkg)
    mix = manifest.mix(traffic["mix"]).Mix(manifest.config(bench, w["config"], root), traffic,
                                           seed, device)
    cuda = device.type == "cuda"
    # the port's CLI runs with TF32 off (run_processor.py); so does the benchmark
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - _T0

    w0 = time.perf_counter()
    while True:
        mix.unit((time.perf_counter() - w0) / seconds)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = mix.steps[-1]["t2"] - w0
    values = {"setup_s": setup_s, **mix.end_to_end(window_s)}
    record = {**mix.layer_record(), "window_s": window_s}
    attempted, failed = mix.attempted()
    summary = None
    if trace:
        # after the window, whose host-clock spans the profiler would slow
        n = int(traffic["trace_units"])
        steps = list(mix.steps)
        summary = trace_mod.traced(lambda: [mix.unit() for _ in range(n)], RANGES, device)
        summary["n_units"] = n
        mix.steps[:] = steps
        print(f"trace: {summary['n_kernels']} kernels, {summary['unlinked_kernels']} not tied "
              "to a launch", file=sys.stderr)
    record["trace"] = summary
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    mix.release()
    numbers = mix.check()
    correct, compared = evaluate(numbers, manifest.limits(cell_name, pkg))

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, cell_name, kind):
        v = manifest.reader(m["name"], pkg)(record) if trace else values[m["name"]]
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["compared"] = compared
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100.run", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    few_threads()
    from . import manifest

    fix_caches(manifest.ROOT)
    import torch

    torch.set_num_threads(int(HOST_THREADS))
    chips = int(manifest.cell(manifest.load(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"bench_h100: modules of JAX loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        bound = f"<= {c['limit']}" if "limit" in c else f">= {c['limit_min']}"
        print(f"compared {name}: {c['value']} {bound} {'holds' if c['holds'] else 'FAILS'}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
