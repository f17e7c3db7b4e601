"""Metrics, logging and profiling (counterpart of ``odam_tpu/utils/metrics.py``):
``MetricLogger`` with its JSONL sink, per-stage wall-clock timers, top-k
accuracy on tensors, a ``torch.profiler`` trace scope, what the tooling
scripts time with (:func:`device_banner` and :func:`time_ms`), and the
port's own tracing: :func:`span` around its stages and the counters that
its modules register, read together by :func:`snapshot`."""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import subprocess
import threading
import time
from collections import defaultdict, deque
from typing import Callable

import torch
from torch.autograd import profiler as _profiler


class SmoothedValue:
    """Windowed median and global average of a scalar series."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Smoothed metrics, one printed line a call and an optional JSONL file."""

    def __init__(self, log_file: str | None = None, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.log_file = log_file

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log(self, **kwargs) -> None:
        """Update the meters, print one line and append one JSON record."""
        self.update(**{k: v for k, v in kwargs.items() if isinstance(v, (int, float))})
        print(self.delimiter.join(f"{k}: {v}" for k, v in kwargs.items()), flush=True)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps({"ts": time.time(), **kwargs}) + "\n")


class StageTimer:
    """Accumulating per-stage wall-clock timers for the pipeline driver."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.self_totals: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def add(self, stage: str, seconds: float, self_seconds: float | None = None) -> None:
        """Count one timing of ``stage`` and its self time, the part not spent
        in the stages nested inside it (by default all of it)."""
        self.totals[stage] += seconds
        self.counts[stage] += 1
        self.self_totals[stage] += seconds if self_seconds is None else self_seconds

    def summary(self) -> dict[str, dict]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1000 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor, ks=(1,)) -> list[float]:
    """Top-k classification accuracy in percent (misc.py:415-431): logits
    [N, C] (or any shape with N leading rows), targets [N]."""
    logits = torch.as_tensor(logits)
    targets = torch.as_tensor(targets).reshape(-1)
    order = torch.argsort(-logits.reshape(len(targets), -1), dim=-1, stable=True)
    out = []
    for k in ks:
        hit = (order[:, :k] == targets[:, None]).any(dim=1)
        out.append(float(hit.double().mean() * 100.0))
    return out


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """``torch.profiler`` scope over the host and, when there is one, the
    card; writes a Chrome trace into ``log_dir`` (no-op when it is None)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_banner(device: torch.device) -> str:
    """The device a measurement runs on.  On the card: its name and the line
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    for it, since a card set below its full power limit runs slower."""
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
        smi = lines[index]
    except (OSError, subprocess.CalledProcessError, IndexError) as e:
        smi = f"nvidia-smi unreadable: {e!r}"
    return f"{torch.cuda.get_device_name(index)} ({smi})"


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Milliseconds a call of ``fn``: one warm call, then ``iters`` calls
    between two CUDA events on the card (the host clock on the CPU), closed
    by a synchronize."""
    fn()
    synchronize(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


# ------------------------------------------------------------ tracing
#
# span(name) marks a stage of the program; every name starts with "odam.".
# - Off (no torch.profiler running and enable() not called): one check of a
#   module flag and one of the profiler's, and nothing is recorded.
# - While a torch.profiler runs: a record_function range of the same name,
#   so the span sits in the device trace, and its host time.  The spans of
#   one traced block are kept apart; the next block starts afresh.
# - Under enable() with no profiler: the host time only.
# A recorded span keeps its name, start and end (time.perf_counter_ns), its
# parent span and the request it serves; a StageTimer keeps each name's
# count, total and self time.  snapshot() also exports every counter that a
# module registered (register_counters), with what each counted over the
# block.

KEEP_SPANS = 512          # the latest recorded spans kept a block
_SPAN_FIELDS = ("id", "name", "parent", "request", "start_ns", "end_ns")

_enabled = False          # enable() called
_tracing = False          # the latest span ran under a profiler
_on = False               # _enabled or _tracing: the flag span() checks
_traced = None            # the latest traced block
_operator = None          # the block of spans recorded under enable()
_ids = itertools.count(1)
_local = threading.local()
_counters: dict[str, list[tuple[dict, Callable[[], None] | None, bool]]] = {}


def register_counters(group: str, counts: dict,
                      reset: Callable[[], None] | None = None) -> None:
    """Export ``counts`` (numbers, or dicts of them, that its module counts
    in place) under ``group`` in :func:`snapshot`.  :func:`reset` calls
    ``reset``, or sets every number of ``counts`` to 0."""
    _counters.setdefault(group, []).append((counts, reset, True))


def register_info(group: str, info: dict) -> None:
    """Export ``info`` (a record such as a library's build) under ``group``
    in :func:`snapshot`; :func:`reset` leaves it."""
    _counters.setdefault(group, []).append((info, None, False))


def _zero(counts: dict) -> None:
    for k, v in counts.items():
        if isinstance(v, dict):
            _zero(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            counts[k] = 0


def _flat(prefix: str, counts: dict, out: dict) -> dict:
    for k, v in counts.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}.", v, out)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"{prefix}{k}"] = v
    return out


def _count_values() -> dict[str, float]:
    """Every registered count by its dotted name ("optim.adam_iterations")."""
    out: dict = {}
    for group, parts in _counters.items():
        for counts, _, counted in parts:
            if counted:
                _flat(f"{group}.", counts, out)
    return out


class _Block:
    """The spans of one traced block, or of the time under enable(): their
    StageTimer, the latest KEEP_SPANS spans, and the counts made from the
    block's first span to the end of its latest top-level one."""

    def __init__(self):
        self.timer = StageTimer()
        self.last: deque = deque(maxlen=KEEP_SPANS)
        self.counts_start = self.counts_end = _count_values()

    def add(self, s: "_Span", end_ns: int) -> None:
        ns = end_ns - s.start_ns
        self.timer.add(s.name, ns * 1e-9, (ns - s.child_ns) * 1e-9)
        parent = s.parent
        self.last.append((s.id, s.name, None if parent is None else parent.id, s.request,
                          s.start_ns, end_ns))
        if parent is None:
            self.counts_end = _count_values()

    def export(self) -> dict:
        t = self.timer
        return {"spans": {k: {"count": t.counts[k], "total_s": t.totals[k],
                              "self_s": t.self_totals[k]} for k in t.totals},
                "last": [dict(zip(_SPAN_FIELDS, r)) for r in self.last],
                "counters": {k: v - self.counts_start.get(k, 0)
                             for k, v in self.counts_end.items()}}


class _Span:
    __slots__ = ("name", "request", "id", "parent", "start_ns", "child_ns", "blocks",
                 "range")

    def __init__(self, name: str, request: int | None):
        self.name, self.request = name, request

    def __enter__(self) -> "_Span":
        global _tracing, _traced, _on
        profiled = _profiler._is_profiler_enabled
        if profiled != _tracing:        # a traced block begins, or has ended
            _tracing = profiled
            _on = _enabled or _tracing
            if profiled:
                _traced = _Block()
        self.blocks = ([_traced] if profiled else []) + ([_operator] if _enabled else [])
        if not self.blocks:
            return self
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.id = next(_ids)
        self.child_ns = 0
        self.range = None
        if profiled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.perf_counter_ns()
        if not self.blocks:
            return
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += end_ns - self.start_ns
        for block in self.blocks:
            block.add(self, end_ns)


_OFF = contextlib.nullcontext()


def span(name: str, request: int | None = None):
    """A context manager around one stage of the program.  ``request`` is
    the id of the request the stage serves (a lane step's number, a
    sequence's); by default its parent's."""
    if _on or _profiler._is_profiler_enabled:
        return _Span(name, request)
    return _OFF


def enable() -> None:
    """Record every span's host time, with no profiler (the operator's
    always-on totals), until :func:`disable`."""
    global _enabled, _on, _operator
    if _operator is None:
        _operator = _Block()
    _enabled = _on = True


def disable() -> None:
    """Stop recording under :func:`enable`; what was recorded stays."""
    global _enabled, _on
    _enabled = False
    _on = _tracing


def reset() -> None:
    """Forget every recorded span and set every registered count to 0."""
    global _traced, _operator, _tracing, _on
    for parts in _counters.values():
        for counts, reset_counts, counted in parts:
            if reset_counts is not None:
                reset_counts()
            elif counted:
                _zero(counts)
    _traced = None
    _operator = _Block() if _enabled else None
    _tracing = False
    _on = _enabled


def snapshot() -> dict:
    """What tracing holds, as plain data: ``profiled``, the latest traced
    block, and ``enabled``, the spans recorded under :func:`enable` (each
    None before its first span, else per span name its count, total and
    self seconds, the latest spans, and the counts made over the block by
    dotted name), and ``counters``, every registered group as it stands."""
    return {"profiled": None if _traced is None else _traced.export(),
            "enabled": None if _operator is None else _operator.export(),
            "counters": {group: {k: copy.deepcopy(v) for counts, _, _ in parts
                                 for k, v in counts.items()}
                         for group, parts in _counters.items()}}
