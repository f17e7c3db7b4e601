"""Metrics, logging and profiling (counterpart of ``odam_tpu/utils/metrics.py``):
``MetricLogger`` with its JSONL sink, per-stage wall-clock timers, top-k
accuracy on tensors, and a ``torch.profiler`` trace scope."""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque

import torch


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

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

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
