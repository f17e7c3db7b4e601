"""Process-group initialization and cross-process aggregation on torch.distributed.

Counterpart of ``odam_tpu/parallel/distributed.py``, with its names.  One
process runs per rank, and the ranks form the mesh of :mod:`.mesh`.

**A departure from JAX.** The no-argument :func:`init_distributed` reads
a launcher's environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).  It is a no-op when
that environment is absent or a group already exists.  When the
environment is present and the init fails, it raises, where JAX's
no-argument form swallows the error: a swallowed failure would leave every
collective a silent no-op on one process while the run looks healthy.

**Backends are explicit.** The default is ``nccl`` for a CUDA device and
``gloo`` for the CPU; nothing switches backend by itself.  ``nccl`` needs
a card a rank (``cuda:LOCAL_RANK``) and raises otherwise; ``gloo`` ranks
may share a card (``cuda:{LOCAL_RANK % device_count}``).  On CUDA tensors
gloo implements ``broadcast`` and ``all_reduce`` only, so every tensor
collective of the port is one of those two: a gather is an ``all_reduce``
of a zero-filled global buffer in which each rank writes its own rows
(:func:`stack_rows`).  The object collectives run on host tensors under
gloo and on the rank's card under nccl.
"""
from __future__ import annotations

import builtins
import datetime
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# Bounds the rendezvous and every collective of the group: a rank that
# never arrives fails the others after this long.
DEFAULT_TIMEOUT_S = 600.0
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_rank_device: dict[str, torch.device] = {}


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     device: str | torch.device | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group; returns this rank's device.

    The explicit form (``init_method`` such as ``tcp://localhost:29500``,
    with ``world_size`` and ``rank``) raises when the group cannot be
    formed within ``timeout_s``.  The no-argument form reads the launcher's
    environment (module docstring).  ``device`` is the kind of device the
    rank runs on (default the card, as every entry point of the port);
    ``backend`` defaults to ``nccl`` for a card and ``gloo`` for the CPU.
    Without a group (no launcher, not initialized) the device is
    ``device`` itself.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return _rank_device.get("device", dev)
    if init_method is None:
        if not all(v in os.environ for v in LAUNCHER_VARS):
            return dev
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if world_size is None or rank is None:
        raise ValueError("init_distributed needs world_size and rank with an init_method")
    backend = backend or default_backend(dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl runs on CUDA devices: pass a cuda device or backend='gloo'")
    dev = _device_of_rank(dev, backend, local_rank(rank))
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device["device"] = dev
    return dev


def local_rank(rank: int | None = None) -> int:
    """The rank's index on its host: ``LOCAL_RANK``, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", process_index() if rank is None else rank))


def _device_of_rank(dev: torch.device, backend: str, local: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if dev.index is not None:
        index = dev.index
    elif backend == "nccl":
        if local >= n:
            raise RuntimeError(f"nccl needs a card a rank: local rank {local} with {n} card(s); "
                               "ranks that share a card need backend='gloo'")
        index = local
    else:
        index = local % n
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def destroy() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device.clear()


def rank_device() -> torch.device | None:
    """The device :func:`init_distributed` chose for this rank, or None."""
    return _rank_device.get("device")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def main_process_only_print() -> None:
    """Silence ``print`` on every rank but the main one."""
    if not is_main_process():
        builtins.print = lambda *a, **k: None


def local_device_count() -> int:
    """The cards this process sees, or 1 (the host) without CUDA."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _host_device() -> torch.device:
    """Where a collective of host data runs: the CPU under gloo, the rank's
    card under nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A detached copy of ``x`` summed over the ranks of ``group``."""
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def stack_rows(tensors: list[torch.Tensor], index: int, count: int, group=None
               ) -> list[torch.Tensor]:
    """Gather fixed-shape tensors from ``count`` ranks: each rank passes its
    own ``tensors`` (same shapes and devices on every rank) and its
    ``index``; every rank gets each tensor's ``count`` copies stacked on a
    new leading axis, in index order.

    One ``all_reduce`` of a zero-filled float64 buffer [count, total size]
    in which each rank writes its own row.  float64 holds every float32,
    bfloat16, bool and integer below 2**53 exactly, and adding zeros keeps
    them, so the gather is exact for those.
    """
    dev = tensors[0].device
    sizes = [t.numel() for t in tensors]
    buf = torch.zeros((count, sum(sizes)), dtype=torch.float64, device=dev)
    buf[index] = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    dist.all_reduce(buf, group=group)
    out, start = [], 0
    for t, n in zip(tensors, sizes):
        out.append(buf[:, start:start + n].reshape(count, *t.shape).to(t.dtype))
        start += n
    return out


def all_gather_arrays(x: np.ndarray) -> np.ndarray:
    """Gather a same-shape host array from every process -> stacked [P, ...]."""
    x = np.asarray(x)
    if process_count() == 1:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_host_device())
    return stack_rows([t], process_index(), process_count())[0].cpu().numpy()


def reduce_scalars(values: dict[str, float], average: bool = True) -> dict[str, float]:
    """Mean (or sum) of a scalar dict over the processes."""
    if process_count() == 1:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                     device=_host_device())
    dist.all_reduce(t)
    if average:
        t /= process_count()
    return {k: float(v) for k, v in zip(keys, t.cpu().tolist())}


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (pickled: trusted peers only)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=_host_device())
    return box[0]


def all_gather_objects(obj: Any) -> list:
    """Every rank's ``obj``, in rank order (pickled: trusted peers only)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def save_on_main(save_fn: Callable, *args: Any, **kwargs: Any) -> None:
    """Run a checkpoint-save callable only on the main process."""
    if is_main_process():
        save_fn(*args, **kwargs)
