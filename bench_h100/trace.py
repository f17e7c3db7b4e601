"""The traced window: ``torch.profiler`` over a few units, reduced in memory to
what the per-layer readers take.

The reduction walks the profiler's events directly (no trace file):

- device operations: kernels, copies and sets, with their names, times and
  correlation ids; their union gives the busy time inside the window;
- launches: the host's runtime calls, whose correlation ids tie each kernel
  to the host time it was launched at;
- host ranges: ``record_function`` ranges (the program's ``odam.*`` spans
  and the benchmark's own ``bench.*`` spans).  A kernel counts under a
  range when its launch lies inside it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

WINDOW = "bench.window"


def _kind(ev) -> str:
    return str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else ""


def summarize(events, ranges_of_interest: tuple[str, ...]) -> dict:
    """Reduce the profiler's events: device busy time and idle gaps inside the
    ``bench.window`` range, kernel time by name, launches, and kernel time
    by host range."""
    device, launches, ranges = [], {}, defaultdict(list)
    for ev in events:
        dt = ev.device_type()
        if dt == torch.autograd.DeviceType.CUDA:
            # record_function ranges also appear on the device's timeline
            if "annotation" in _kind(ev) or ev.name().startswith(("odam.", "bench.")):
                continue
            device.append((ev.start_ns(), ev.end_ns(), ev.name(), _kind(ev),
                           ev.correlation_id(), ev.linked_correlation_id()))
        elif ev.is_user_annotation() or ev.name().startswith(("odam.", "bench.")):
            ranges[ev.name()].append((ev.start_ns(), ev.end_ns()))
        elif (_kind(ev) in ("cuda_runtime", "cuda_driver")
              or ev.name().startswith(("cuda", "cu"))) and ev.correlation_id():
            launches[ev.correlation_id()] = ev.start_ns()
    if not ranges.get(WINDOW):
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = ranges[WINDOW][0]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    kernels = [d for d in device if d[3] == "kernel" or (
        d[3] not in ("gpu_memcpy", "gpu_memset") and "memcpy" not in d[2].lower()
        and "memset" not in d[2].lower())]
    # the union of device intervals, and the idle gaps between them
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, *_ in sorted((max(d[0], w0), min(d[1], w1)) + d[2:] for d in device):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    by_name = defaultdict(float)
    for s, e, name, *_ in kernels:
        by_name[name] += (e - s) * 1e-9
    # kernel time under each host range of interest, by launch time
    spans = {n: sorted(ranges.get(n, [])) for n in ranges_of_interest}
    under = {n: 0.0 for n in ranges_of_interest}
    unlinked = 0
    for s, e, name, kind, corr, linked in kernels:
        t = launches.get(corr, launches.get(linked))
        if t is None:
            unlinked += 1
            continue
        for n, iv in spans.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                under[n] += (e - s) * 1e-9
    # each idle gap labelled by the innermost host range around its middle
    labelled = defaultdict(float)
    all_ranges = sorted((s, e, n) for n, iv in ranges.items() if n != WINDOW for s, e in iv)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inner = [(e - s, n) for s, e, n in all_ranges if s <= mid <= e]
        labelled[min(inner)[1] if inner else "host (no range)"] += (g1 - g0) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9, "n_kernels": len(kernels),
            "kernel_s_by_name": dict(by_name), "device_s_under": under,
            "unlinked_kernels": unlinked,
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in labelled.items()), key=lambda x: -x[1])[:10]}


def traced(run_units, ranges_of_interest: tuple[str, ...], device: torch.device) -> dict:
    """Run ``run_units()`` under the profiler inside a ``bench.window`` range
    and summarize it."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run_units()
            if device.type == "cuda":
                torch.cuda.synchronize()
    return summarize(prof.profiler.kineto_results.events(), ranges_of_interest)
