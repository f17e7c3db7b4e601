"""Training-log metrics: what the train scripts need of
``odam_tpu/utils/metrics.py``, its ``MetricLogger`` with the JSONL sink."""
from __future__ import annotations

import json
import time
from collections import defaultdict, deque


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
