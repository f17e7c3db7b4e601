"""Static-shape track store and observation log on the device.

Counterpart of ``odam_tpu/runtime/tracker.py``: a fixed-capacity rolling
window per track slot ([T, W, 82], oldest first, -1 padded), running sums for
the mean state, LRU eviction of unprotected slots under fresh global ids,
and a device-resident FrameLog that the host drains in chunks.

The store functions return new NamedTuples, as in JAX.  ``log_frame``
writes into the log's buffers in place (the log is 59 MB at the default
6000 frames, too large to copy every frame) and returns them.

Track row layout (82 columns): 0 frame_id | 1 class | 2:6 bbox xyxy (pixels)
| 6:9 dims | 9:12 t_wo | 12 azi_wo | 13 score | 14:78 code | 78:82
projected bbox (pixels).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TRACK_DIM = 82


class TrackStore(NamedTuple):
    window: torch.Tensor      # [T, W, 82] rolling observation window (-1 padded)
    length: torch.Tensor      # [T] int32 observations currently in the window
    n_obs: torch.Tensor       # [T] int32 total observations ever
    sum_t: torch.Tensor       # [T, 3] running sum of t_wo
    sum_azi: torch.Tensor     # [T] running sum of azi_wo
    sum_dims: torch.Tensor    # [T, 3] running sum of dims
    active: torch.Tensor      # [T] bool
    count: torch.Tensor       # [] int32 number of active tracks
    track_id: torch.Tensor    # [T] int32 global track id per slot, -1 = never used
    last_frame: torch.Tensor  # [T] float32 frame_id of the latest observation
    next_id: torch.Tensor     # [] int32 next global track id
    n_evicted: torch.Tensor   # [] int32 slots recycled under capacity pressure
    n_dropped: torch.Tensor   # [] int32 new tracks dropped (no assignable slot)

    @property
    def capacity(self) -> int:
        return self.window.shape[0]

    @property
    def window_size(self) -> int:
        return self.window.shape[1]


def init_store(max_tracks: int, window: int, device) -> TrackStore:
    i32, f32 = torch.int32, torch.float32
    zi = lambda *s: torch.zeros(s, dtype=i32, device=device)  # noqa: E731
    zf = lambda *s: torch.zeros(s, dtype=f32, device=device)  # noqa: E731
    return TrackStore(
        window=torch.full((max_tracks, window, TRACK_DIM), -1.0, dtype=f32, device=device),
        length=zi(max_tracks), n_obs=zi(max_tracks),
        sum_t=zf(max_tracks, 3), sum_azi=zf(max_tracks), sum_dims=zf(max_tracks, 3),
        active=torch.zeros(max_tracks, dtype=torch.bool, device=device),
        count=zi(),
        track_id=torch.full((max_tracks,), -1, dtype=i32, device=device),
        last_frame=torch.full((max_tracks,), -1.0, dtype=f32, device=device),
        next_id=zi(), n_evicted=zi(), n_dropped=zi(),
    )


def mean_state(store: TrackStore) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-track arithmetic means (t_wo [T,3], azi_wo [T], dims [T,3]); dims >= 0.05."""
    n = torch.clamp(store.n_obs, min=1).to(store.sum_t.dtype)
    t = store.sum_t / n[:, None]
    azi = store.sum_azi / n
    dims = torch.clamp(store.sum_dims / n[:, None], min=0.05)
    return t, azi, dims


def scatter_drop(base: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base`` with ``base[index[i]] = values[i]``; index == len(base) is dropped.
    Indices below len(base) must be unique.

    JAX drops out-of-range scatters (mode="drop"); on CUDA torch would assert,
    so dropped rows go to one spare row that is cut off.
    """
    pad = torch.cat([base, base[:1]], dim=0)
    pad[index] = values.to(base.dtype)
    return pad[:-1]


def append_rows(store: TrackStore, rows: torch.Tensor, slots: torch.Tensor,
                valid: torch.Tensor) -> TrackStore:
    """Push detection rows into their slots' rolling windows.

    Args:
        rows: [N, 82] world-frame track rows.
        slots: [N] int32 target slot per row, unique among valid rows.
        valid: [N] bool; invalid rows are dropped.

    The JAX package pushes the rows one at a time; since the slots of valid
    rows are unique, one vectorised scatter gives the same store: a full
    window shifts its oldest row out, and the new row lands at the end.
    """
    T, W = store.capacity, store.window_size
    N = rows.shape[0]
    s = torch.clamp(slots.long(), 0, T - 1)
    dst = torch.where(valid, s, T)                       # T = dropped

    cur = store.window[s]                                # [N, W, 82]
    full = store.length[s] >= W
    shifted = torch.where(full[:, None, None], torch.roll(cur, -1, dims=1), cur)
    pos = torch.clamp(store.length[s].long(), max=W - 1)
    shifted[torch.arange(N, device=rows.device), pos] = rows

    inc = torch.where(full, 0, 1).to(torch.int32)
    active = scatter_drop(store.active, dst, torch.ones_like(valid))
    return store._replace(
        window=scatter_drop(store.window, dst, shifted),
        length=scatter_drop(store.length, dst, store.length[s] + inc),
        n_obs=scatter_drop(store.n_obs, dst, store.n_obs[s] + 1),
        sum_t=scatter_drop(store.sum_t, dst, store.sum_t[s] + rows[:, 9:12]),
        sum_azi=scatter_drop(store.sum_azi, dst, store.sum_azi[s] + rows[:, 12]),
        sum_dims=scatter_drop(store.sum_dims, dst, store.sum_dims[s] + rows[:, 6:9]),
        active=active,
        last_frame=scatter_drop(store.last_frame, dst, rows[:, 0]),
        count=active.sum().to(torch.int32),
    )


def assign_new_slots(store: TrackStore, is_new: torch.Tensor,
                     protected: torch.Tensor | None = None
                     ) -> tuple[TrackStore, torch.Tensor]:
    """Allocate slots and fresh global ids for newly spawned tracks.

    Free slots first (ascending index), then the least-recently-observed
    unprotected active slot (stable on index), never a protected one; a
    spawn with no assignable slot drops and counts in ``n_dropped``.

    Returns:
        (store with recycled slots cleared, slots [N] int32, -1 where dropped).
    """
    T = store.capacity
    dev = store.window.device
    if protected is None:
        protected = torch.zeros(T, dtype=torch.bool, device=dev)
    free = ~store.active
    evictable = store.active & ~protected

    idx = torch.arange(T, dtype=torch.int64, device=dev)
    lru_key = torch.where(evictable, store.last_frame, torch.inf)
    lru_rank = torch.argsort(torch.argsort(lru_key, stable=True), stable=True)
    key = torch.where(free, idx, torch.where(evictable, T + lru_rank, 2 * T + idx))
    order = torch.argsort(key, stable=True)

    n_assignable = free.sum() + evictable.sum()
    rank = torch.cumsum(is_new.long(), dim=0) - 1
    cand = order[torch.clamp(rank, 0, T - 1)]
    ok = is_new & (rank < n_assignable) & (rank < T)
    slots = torch.where(ok, cand, -1).to(torch.int32)

    scatter_to = torch.where(ok, cand, T)
    taken = scatter_drop(torch.zeros(T, dtype=torch.bool, device=dev), scatter_to,
                          torch.ones_like(ok))
    new_ids = (store.next_id + rank).to(torch.int32)
    slot_ids = scatter_drop(torch.full((T,), -1, dtype=torch.int32, device=dev),
                             scatter_to, new_ids)
    evicted = taken & store.active
    i32 = torch.int32
    store = store._replace(
        window=torch.where(taken[:, None, None], -1.0, store.window),
        length=torch.where(taken, 0, store.length).to(i32),
        n_obs=torch.where(taken, 0, store.n_obs).to(i32),
        sum_t=torch.where(taken[:, None], 0.0, store.sum_t),
        sum_azi=torch.where(taken, 0.0, store.sum_azi),
        sum_dims=torch.where(taken[:, None], 0.0, store.sum_dims),
        active=store.active & ~taken,
        count=(store.active & ~taken).sum().to(i32),
        track_id=torch.where(taken, slot_ids, store.track_id),
        last_frame=torch.where(taken, -1.0, store.last_frame),
        next_id=(store.next_id + ok.sum()).to(i32),
        n_evicted=(store.n_evicted + evicted.sum()).to(i32),
        n_dropped=(store.n_dropped + (is_new & ~ok).sum()).to(i32),
    )
    return store, slots


class FrameLog(NamedTuple):
    """Device-resident append-only observation log, keyed by global track id."""

    rows: torch.Tensor    # [F_cap, N, 82] world-frame rows of attached detections
    ids: torch.Tensor     # [F_cap, N] int32 global track id per row, -1 = not attached
    count: torch.Tensor   # [] int32 frames logged
    n_lost: torch.Tensor  # [] int32 frames dropped because the log was full

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]


def init_log(max_frames: int, max_dets: int, device) -> FrameLog:
    return FrameLog(
        rows=torch.zeros((max_frames, max_dets, TRACK_DIM), dtype=torch.float32, device=device),
        ids=torch.full((max_frames, max_dets), -1, dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        n_lost=torch.zeros((), dtype=torch.int32, device=device),
    )


def log_frame(log: FrameLog, rows: torch.Tensor, ids: torch.Tensor) -> FrameLog:
    """Append one frame's attach results (in place); a full log drops the
    frame and counts it in ``n_lost``."""
    full = log.count >= log.capacity
    idx = torch.clamp(log.count, max=log.capacity - 1).long().reshape(1)
    write_rows = torch.where(full, log.rows.index_select(0, idx)[0], rows)
    write_ids = torch.where(full, log.ids.index_select(0, idx)[0], ids.to(torch.int32))
    log.rows.index_copy_(0, idx, write_rows[None])
    log.ids.index_copy_(0, idx, write_ids[None])
    return log._replace(count=torch.clamp(log.count + 1, max=log.capacity).to(torch.int32),
                        n_lost=(log.n_lost + full.to(torch.int32)).to(torch.int32))


def drain_log(log: FrameLog) -> dict[int, np.ndarray]:
    """One host pull: observation rows grouped by global track id, ids in
    spawn order and frame order kept within each id."""
    n = int(log.count)
    flat_ids = log.ids[:n].cpu().numpy().reshape(-1)
    flat_rows = log.rows[:n].cpu().numpy().reshape(-1, TRACK_DIM)
    keep = flat_ids >= 0
    ids = flat_ids[keep]
    rows = flat_rows[keep]
    if len(ids) == 0:
        return {}
    order = np.argsort(ids, kind="stable")
    ids, rows = ids[order], rows[order]
    uniq, starts = np.unique(ids, return_index=True)
    bounds = np.append(starts, len(ids))
    return {int(u): rows[bounds[i]:bounds[i + 1]] for i, u in enumerate(uniq)}
