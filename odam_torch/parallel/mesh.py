"""The ranks as a mesh, and sharding helpers.

Counterpart of ``odam_tpu/parallel/mesh.py``.  JAX names the axes of a
device mesh: ``dp`` (data parallel: frames, train batches or scenes over
the devices) and ``mp`` (map parallel: the mapping solve's object axis).
Here a device is a rank, one process each, and a sharded array is each
rank's block of rows of a global batch.  Where JAX compiles one global
program and lets XLA insert the collectives, the port's paths call
``torch.distributed`` themselves: the gradient and normalizer all-reduces
of training (:mod:`odam_torch.models.training`), and :func:`gather_batch`
after the sharded detector and the sharded solve.

A :class:`Mesh` has one axis longer than 1.  Its ranks are the first
``mesh.size`` of the world; a rank past them holds no shard (the scene
runner's ``max(d | P, d <= world)`` rule leaves such ranks idle) but must
still join every collective of the world group.  Without a process group
(one process, not launched) the mesh has size 1 and no collective runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from . import distributed


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    rank: int                       # this process's global rank
    device: torch.device            # this rank's device
    group: Any = None               # the process group; None: one process

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def index(self, axis: str) -> int | None:
        """This rank's position along ``axis``: 0 on an axis of size 1, None
        on a rank past the mesh."""
        if self.rank >= self.size:
            return None
        return self.rank if self.shape[axis] > 1 else 0


def make_mesh(axis_sizes: dict[str, int] | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """A mesh over the ranks; the default is every rank on one ``dp`` axis.

    The axis sizes multiply to at most the world size, with one axis longer
    than 1.  ``device`` defaults to the one :func:`distributed.init_distributed`
    chose for this rank, else to the card."""
    world = distributed.process_count()
    if axis_sizes is None:
        axis_sizes = {"dp": world}
    sizes = tuple(int(s) for s in axis_sizes.values())
    if min(sizes) < 1 or int(np.prod(sizes)) > world:
        raise ValueError(f"mesh {dict(axis_sizes)} over {world} rank(s)")
    if sum(s > 1 for s in sizes) > 1:
        raise ValueError(f"mesh {dict(axis_sizes)}: the port's mesh has one axis longer than 1")
    dev = resolve_device(device) if device is not None else (
        distributed.rank_device() or resolve_device(None))
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(tuple(axis_sizes), sizes, distributed.process_index(), dev, group)


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of nested tuples, NamedTuples, lists and dicts
    (a None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _block(mesh: Mesh, axis: str) -> tuple[int, int]:
    index = mesh.index(axis)
    if index is None:
        raise ValueError(f"rank {mesh.rank} lies past the {mesh.size}-rank mesh")
    return index, mesh.shape[axis]


def shard_batch(batch, mesh: Mesh, axis: str = "dp"):
    """This rank's rows of a global batch (numpy arrays or tensors, in any
    tree): block ``index`` of ``mesh.shape[axis]`` along the leading axis.
    Raises when the leading axis does not divide, as ``NamedSharding``
    does."""
    index, k = _block(mesh, axis)

    def take(x):
        n = x.shape[0]
        if n % k:
            raise ValueError(f"a leading axis of {n} does not divide over the {k}-way "
                             f"mesh axis {axis!r}")
        return x[index * (n // k):(index + 1) * (n // k)]

    return tree_map(take, batch)


def shard_local_batch(local_batch, mesh: Mesh, axis: str = "dp"):
    """A rank's own shard of a global batch, as it is: each process loaded
    its rows itself.  Checks that every rank holds the same number of rows
    in every leaf (so that the global batch is ``mesh.shape[axis]`` times
    it) and returns ``local_batch``."""
    _block(mesh, axis)
    if mesh.group is None:
        return local_batch
    rows = np.asarray([x.shape[0] for x in tree_leaves(local_batch)], np.int64)
    every = distributed.all_gather_arrays(rows)[:mesh.size]
    if not (every == rows).all():
        raise ValueError(f"ranks hold different local batches: rows {every.tolist()}")
    return local_batch


def gather_batch(batch, mesh: Mesh, axis: str = "dp"):
    """The global batch from every rank's block of a fixed-shape tensor tree
    (the inverse of :func:`shard_batch`), on every rank, in one collective
    (:func:`distributed.stack_rows`: exact for float32, bfloat16, bool and
    integers below 2**53)."""
    index, k = _block(mesh, axis)
    if mesh.group is None or k == 1:
        return batch
    if mesh.size != distributed.process_count():
        raise ValueError("gather_batch needs a mesh over every rank")
    leaves = tree_leaves(batch)
    stacked = iter(distributed.stack_rows(leaves, index, k, mesh.group))
    return tree_map(lambda x: next(stacked).reshape(k * x.shape[0], *x.shape[1:]), batch)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    fill=0.0) -> np.ndarray:
    """Pad an axis up to a multiple (so batches divide evenly over the mesh)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill)
