"""Prefetching host-side frame loader and the host-to-device frame feed.

Counterpart of ``odam_tpu/data/loader.py``.  ``PrefetchLoader`` (a copy)
runs IO, decode and preprocessing in background threads with a bounded
queue; ``device_prefetch`` starts frame n+1's copy to the device while frame
n's step runs, from pinned host memory with ``non_blocking`` copies (the
JAX package uses ``jax.device_put``).
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


class PrefetchLoader:
    """Run ``load_fn`` over items in background threads, yielding in order.

    Args:
        items: work list (e.g. frame names).
        load_fn: item -> loaded value (called in worker threads; must be
            thread-safe — NumPy/PIL decode is).
        num_workers: decode threads.
        buffer_size: max loaded-but-unconsumed items.
    """

    def __init__(self, items: Iterable, load_fn: Callable, num_workers: int = 2,
                 buffer_size: int = 4):
        self.items = list(items)
        self.load_fn = load_fn
        self.num_workers = max(1, num_workers)
        self.buffer_size = max(1, buffer_size)

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self) -> Iterator:
        n = len(self.items)
        if n == 0:
            return
        results: dict[int, object] = {}
        results_lock = threading.Lock()
        results_ready = threading.Condition(results_lock)
        task_q: queue.Queue = queue.Queue()
        errors: list[BaseException] = []
        # Admission control: at most buffer_size items loaded ahead of the
        # consumer cursor.
        tickets = threading.Semaphore(self.buffer_size)
        stop = threading.Event()

        for i in range(n):
            task_q.put(i)

        def worker():
            while not stop.is_set():
                # Acquire the buffer ticket BEFORE taking a task so in-flight
                # work is always the lowest-index remaining items — otherwise
                # a small buffer could starve the index the consumer waits on.
                tickets.acquire()
                if stop.is_set():
                    return
                try:
                    idx = task_q.get_nowait()
                except queue.Empty:
                    tickets.release()
                    return
                try:
                    value = self.load_fn(self.items[idx])
                except BaseException as e:  # propagate to consumer
                    with results_ready:
                        errors.append(e)
                        results_ready.notify_all()
                    return
                with results_ready:
                    results[idx] = value
                    results_ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with results_ready:
                    while i not in results and not errors:
                        results_ready.wait()
                    if errors:
                        raise errors[0]
                    value = results.pop(i)
                tickets.release()
                yield value
        finally:
            stop.set()
            # unblock any worker waiting on a ticket
            for _ in threads:
                tickets.release()
            for t in threads:
                t.join(timeout=1.0)


def to_device(x, device: torch.device):
    """A numpy array (or a tuple of them, YUV 4:2:0) as a tensor on ``device``;
    to a CUDA device from pinned memory without blocking."""
    if isinstance(x, tuple):
        return tuple(to_device(p, device) for p in x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.require(x, requirements=("C", "W")))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(frame_iter: Iterable, device: torch.device, lookahead: int = 1) -> Iterator:
    """Overlap host-to-device frame copies with the device step.

    Wraps an iterator of ``(frame_id, image, ...)`` tuples and starts the
    copy of the next ``lookahead`` images before yielding the current one.
    Images may be arrays or tuples of arrays (YUV 4:2:0 transport).
    """
    it = iter(frame_iter)
    pending: collections.deque = collections.deque()
    for item in it:
        fid, img, *rest = item
        pending.append((fid, to_device(img, device), *rest))   # the copy starts now
        if len(pending) > max(1, lookahead):
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def scene_frame_loader(index, scene: str, frames: list[str],
                       preprocess: Callable | None = None,
                       num_workers: int = 2, buffer_size: int = 4):
    """Prefetching loader over one ScanNet scene's frames.

    Yields (frame_id, image, T_cw) with decode and preprocessing off the
    critical path.  ``preprocess`` maps the raw RGB array (e.g.
    ``transforms.preprocess_image``).
    """
    from PIL import Image

    from . import scannet

    def load(frame):
        T_cw = scannet.read_extrinsic(index.pose_path(scene, frame))
        rgb = np.asarray(Image.open(index.image_path(scene, frame)))
        if preprocess is not None:
            rgb = preprocess(rgb)
        return int(frame), rgb, T_cw

    return PrefetchLoader(frames, load, num_workers, buffer_size)
