"""The exact assignment on the host: a copy of ``odam_torch/ops/lap.py``'s
plain solver (``_solve_square_leq``, JAX's solver step for step in
float32), with the port's ``masked_assignment`` and ``match_by_score``
around it.  Every problem runs on the host in NumPy; it imports nothing of
``odam_torch``."""
from __future__ import annotations

import numpy as np
import torch

_BIG_COST = 1e6


def solve_square_leq(c: np.ndarray) -> np.ndarray:
    """cost [R, C] float32 with R <= C -> col4row [R] int32."""
    c = np.ascontiguousarray(c, dtype=np.float32)
    R, C = c.shape
    inf = np.float32(np.inf)
    u = np.zeros(R, np.float32)
    v = np.zeros(C, np.float32)
    row4col = np.full(C, -1, np.int32)
    col4row = np.full(R, -1, np.int32)
    rows = np.arange(R)
    for cur_row in range(R):
        spc = np.full(C, inf, np.float32)
        path = np.full(C, -1, np.int32)
        sc = np.zeros(C, bool)
        sr = np.zeros(R, bool)
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
            j = int(np.argmax(unassigned) if unassigned.any() else np.argmax(is_min))
            sc[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
            min_val = lowest
        u[cur_row] += min_val
        other_rows = sr & (rows != cur_row)
        spc_at_row_cols = spc[np.clip(col4row, 0, C - 1)]
        u = np.where(other_rows, u + min_val - spc_at_row_cols, u)
        v = np.where(sc, v - (min_val - spc), v)
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            prev = int(col4row[i])
            col4row[i] = j
            j = prev
            if i == cur_row:
                break
    return col4row


def solve(cost: torch.Tensor) -> torch.Tensor:
    """cost [..., R, C], R <= C -> col4row [..., R] int32 on cost's device."""
    *lead, R, C = cost.shape
    flat = cost.detach().float().cpu().numpy().reshape(-1, R, C)
    out = np.stack([solve_square_leq(c) for c in flat]) if len(flat) else \
        np.zeros((0, R), np.int32)
    return torch.from_numpy(out.reshape(*lead, R)).to(cost.device)


def masked_assignment(cost, row_mask, col_mask):
    R, C = cost.shape[-2:]
    cost = torch.clamp(cost.float(), -_BIG_COST, _BIG_COST)
    valid = row_mask[..., :, None] & col_mask[..., None, :]
    any_valid = valid.flatten(-2).any(-1)
    zero = torch.zeros((), dtype=torch.float32, device=cost.device)
    lo = torch.where(any_valid, torch.where(valid, cost, torch.inf).flatten(-2).amin(-1), zero)
    hi = torch.where(any_valid, torch.where(valid, cost, -torch.inf).flatten(-2).amax(-1), zero)
    span = torch.clamp(hi - lo, min=1e-6)
    big = (span * 128.0)[..., None, None]
    cost = torch.where(valid, cost - lo[..., None, None], big)
    if R <= C:
        col4row = solve(cost)
    else:
        row4col = solve(cost.transpose(-1, -2)).long()
        cols = torch.arange(C, dtype=torch.int32, device=cost.device).expand_as(row4col)
        col4row = torch.full(cost.shape[:-1], -1, dtype=torch.int32, device=cost.device)
        col4row = col4row.scatter(-1, row4col, cols)
    safe = torch.clamp(col4row, 0, C - 1).long()
    ok = (row_mask & (col4row >= 0) & torch.gather(col_mask, -1, safe)
          & (torch.gather(cost, -1, safe[..., None])[..., 0] < big[..., 0] / 2))
    return torch.where(ok, col4row, -1).int()


def match_by_score(score, threshold, row_mask, col_mask):
    """LAP on cost = 1 - score; matches above ``threshold``: [..., N] track per
    detection, -1 unmatched."""
    M, N = score.shape[-2:]
    lead, dev = score.shape[:-2], score.device
    col4row = masked_assignment(1.0 - score, row_mask, col_mask)
    safe = torch.clamp(col4row, 0, N - 1).long()
    ok = (col4row >= 0) & (torch.gather(score, -1, safe[..., None])[..., 0] > threshold)
    idx = torch.where(ok, col4row.long(), N)
    rows = torch.arange(M, dtype=torch.int32, device=dev).expand(lead + (M,))
    out = torch.full(lead + (N + 1,), -1, dtype=torch.int32, device=dev).scatter(-1, idx, rows)
    return torch.where(col_mask, out[..., :N], -1).int()
