"""Linear assignment: the exact shortest-augmenting-path solver and the decodes.

Counterpart of ``odam_tpu/ops/lap.py``.  The JAX package runs the solver on
the TPU inside its step; its Dijkstra and augmentation loops exit on the
data.  Here the exact decode runs on the host, on purpose: the associator
copies its [T+1, N+1] log assignment to the CPU once per frame and
:func:`match_by_score` solves it there with the same float32 arithmetic and
tie-breaks, step for step.  :func:`greedy_peel_match` is plain tensor code
and runs on any device.
"""
from __future__ import annotations

import numpy as np
import torch

_BIG_COST = 1e6


def _solve_square_leq(cost: torch.Tensor) -> torch.Tensor:
    """Core solver; cost [R, C] on the CPU with R <= C -> col4row [R] int32."""
    c = np.ascontiguousarray(cost.detach().cpu().numpy(), dtype=np.float32)
    R, C = c.shape
    inf = np.float32(np.inf)
    u = np.zeros(R, np.float32)
    v = np.zeros(C, np.float32)
    row4col = np.full(C, -1, np.int32)
    col4row = np.full(R, -1, np.int32)
    rows = np.arange(R)
    for cur_row in range(R):
        spc = np.full(C, inf, np.float32)       # shortest path cost per column
        path = np.full(C, -1, np.int32)         # predecessor row per column
        sc = np.zeros(C, bool)                  # scanned columns
        sr = np.zeros(R, bool)                  # scanned rows
        i, min_val, sink = cur_row, np.float32(0.0), -1
        while sink < 0:
            sr[i] = True
            r = min_val + c[i] - u[i] - v
            better = ~sc & (r < spc)
            spc = np.where(better, r, spc)
            path = np.where(better, np.int32(i), path)
            masked = np.where(sc, inf, spc)
            lowest = masked.min()
            is_min = (masked <= lowest) & ~sc
            unassigned = is_min & (row4col < 0)
            # prefer an unassigned column among the minimizers
            j = int(np.argmax(unassigned) if unassigned.any() else np.argmax(is_min))
            sc[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
            min_val = lowest

        # dual updates (JV potentials)
        u[cur_row] += min_val
        other_rows = sr & (rows != cur_row)
        spc_at_row_cols = spc[np.clip(col4row, 0, C - 1)]
        u = np.where(other_rows, u + min_val - spc_at_row_cols, u)
        v = np.where(sc, v - (min_val - spc), v)

        # augment along the alternating path back to cur_row
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            prev = int(col4row[i])
            col4row[i] = j
            j = prev
            if i == cur_row:
                break
    return torch.from_numpy(col4row)


def masked_assignment(cost: torch.Tensor, row_mask: torch.Tensor,
                      col_mask: torch.Tensor) -> torch.Tensor:
    """Assignment over the valid submatrix of a padded CPU cost matrix.

    Invalid slots are priced at 128x the valid-cost span above the shifted
    valid costs (scale-aware, as in the JAX package); an assignment that
    touches an invalid slot is reported as unmatched.

    Returns:
        col4row [R] int32: assigned column per row, -1 where unmatched.
    """
    R, C = cost.shape
    cost = cost.float()
    valid = row_mask[:, None] & col_mask[None, :]
    cost = torch.clamp(cost, -_BIG_COST, _BIG_COST)
    if bool(valid.any()):
        lo = torch.where(valid, cost, torch.inf).min()
        hi = torch.where(valid, cost, -torch.inf).max()
    else:
        lo = hi = torch.zeros((), dtype=torch.float32)
    span = torch.clamp(hi - lo, min=1e-6)
    big = span * 128.0
    cost = torch.where(valid, cost - lo, big)
    if R <= C:
        col4row = _solve_square_leq(cost)
    else:
        row4col = _solve_square_leq(cost.T).long()
        col4row = torch.full((R,), -1, dtype=torch.int32)
        col4row[row4col] = torch.arange(C, dtype=torch.int32)
    safe = torch.clamp(col4row, 0, C - 1).long()
    ok = (row_mask & (col4row >= 0) & col_mask[safe]
          & (cost[torch.arange(R), safe] < big / 2))
    return torch.where(ok, col4row, -1).int()


def match_by_score(score: torch.Tensor, threshold: float,
                   row_mask: torch.Tensor | None = None,
                   col_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact decode on the host: LAP on cost = 1 - score, keep matches whose
    score exceeds ``threshold``.

    Args:
        score: [M, N] (tracks x detections) CPU score matrix in [0, 1].

    Returns:
        [N] int32 track index per detection, -1 if unmatched.
    """
    M, N = score.shape
    if row_mask is None:
        row_mask = torch.ones(M, dtype=torch.bool)
    if col_mask is None:
        col_mask = torch.ones(N, dtype=torch.bool)
    col4row = masked_assignment(1.0 - score, row_mask, col_mask)
    rows = torch.arange(M)
    safe = torch.clamp(col4row, 0, N - 1).long()
    ok = (col4row >= 0) & (score[rows, safe] > threshold)
    # scatter track ids into matched detection slots; rejected rows land on
    # the extra slot N, which is dropped
    idx = torch.where(ok, col4row.long(), N)
    out = torch.full((N + 1,), -1, dtype=torch.int32)
    out[idx[ok]] = rows[ok].int()
    return torch.where(col_mask, out[:N], -1).int()


def greedy_peel_match(score: torch.Tensor, threshold: float,
                      row_mask: torch.Tensor | None = None,
                      col_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy global-argmax decode: [..., M, N] score -> [..., N] int32 track
    ids, each matrix of a batch on its own.

    Takes the highest remaining score, assigns that pair if it clears the
    threshold, and removes its row and column; min(M, N) steps for the whole
    batch, no host sync.
    """
    M, N = score.shape[-2:]
    lead = score.shape[:-2]
    dev = score.device
    s = score.float()
    if row_mask is not None:
        s = torch.where(row_mask[..., :, None], s, -torch.inf)
    if col_mask is not None:
        s = torch.where(col_mask[..., None, :], s, -torch.inf)
    rows = torch.arange(M, device=dev)
    cols = torch.arange(N, device=dev)
    out = torch.full(lead + (N,), -1, dtype=torch.int32, device=dev)
    for _ in range(min(M, N)):
        # index tensors of one element a matrix keep every step on the device
        flat = torch.argmax(s.reshape(lead + (M * N,)), dim=-1, keepdim=True)
        r, c = flat // N, flat % N
        ok = s.reshape(lead + (M * N,)).gather(-1, flat) > threshold
        out = torch.where((cols == c) & ok, r.int(), out)
        s = s.masked_fill((rows == r)[..., :, None] | (cols == c)[..., None, :], -torch.inf)
    if col_mask is not None:
        out = torch.where(col_mask, out, -1)
    return out.int()
