"""Linear assignment: the exact shortest-augmenting-path solver and the decodes.

Counterpart of ``odam_tpu/ops/lap.py``.  The JAX package runs the solver on
the TPU inside its step.  Here :func:`solve` runs a batch of problems
[S, R, C] (R <= C) in one launch of a hand-written CUDA kernel of
``odam_torch/csrc/lap.cu`` (one warp a problem), on the current stream and
with no host read, so the exact decode stays on the card like every other
op of the step.  :func:`plan` picks the kernel: the ``registers`` route for
C <= 256 (each lane's columns in registers, the cost staged in shared
memory), the ``shared`` route (all state in shared memory) above.  Both
compute JAX's solver step for step, with the same float32 arithmetic and
tie-breaks; their plain version is the host solver
:func:`_solve_square_leq`, which :func:`solve` runs for a CPU tensor.  On a
CUDA tensor a kernel runs or the call raises: there is no fallback.  Both
are counted as kernel ``lap_solve`` in group ``lap`` of :mod:`.kernels`
(the library :data:`.kernels.LAP`), with the launches by route in the extra
``ROUTE_LAUNCHES``.

Around the solver, :func:`masked_assignment`, :func:`match_by_score` and
:func:`linear_sum_assignment` are batched over leading axes and written as
JAX writes them, with no host sync: the scale-aware pricing selects with
``torch.where`` on ``any_valid``, R > C solves the transpose, and the decode
scatters rejected rows into a dropped slot.  :func:`greedy_peel_match` is
plain tensor code.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kernels import KERNELS

_BIG_COST = 1e6
SMEM_LIMIT = 232448            # dynamic shared memory a block may use on the H100
REGISTER_K = (1, 2, 4, 8)      # columns a lane of the registers route: C <= 32 K


def smem_bytes(R: int, C: int) -> int:
    """Shared memory of one problem's state in the shared route's kernel
    (lap.cu's lap_kernel), rounded up to 16 bytes as the launch rounds it."""
    return (9 * R + 17 * C + 15) // 16 * 16


class Plan(NamedTuple):
    route: str            # "registers" (lap_regs_kernel<K>) or "shared" (lap_kernel)
    K: int                # columns a lane in registers (0 on the shared route)
    smem_bytes: int       # dynamic shared memory of one block
    staged_rows: int      # rows of the cost staged in shared memory (registers route)
    staged: bool          # the whole problem staged


def plan(R: int, C: int) -> Plan:
    """How :func:`solve` runs an [R, C] problem (R <= C) on the card: the one
    place the choice is made.  C <= 256 takes the registers route with the
    least K of ``REGISTER_K`` that holds C, the cost staged as far as
    ``SMEM_LIMIT`` holds its rows; a wider problem the shared route, refused
    when its state does not fit a block."""
    if R > C:
        raise ValueError(f"solve takes R <= C, got [{R}, {C}]: solve the transpose")
    if C <= 32 * REGISTER_K[-1]:
        K = next(k for k in REGISTER_K if 32 * k >= C)
        rows = min(R, SMEM_LIMIT // (4 * C)) if C else 0
        return Plan("registers", K, (4 * rows * C + 15) // 16 * 16, rows, rows == R)
    smem = smem_bytes(R, C)
    if smem > SMEM_LIMIT:
        raise ValueError(f"solve: a [{R}, {C}] problem needs {smem} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may use")
    return Plan("shared", 0, smem, 0, False)


def _solve_square_leq(cost: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
    """The plain version: cost [R, C] on the CPU with R <= C -> col4row [R]
    int32, JAX's ``_solve_square_leq`` step for step in float32.

    ``stats``, if given, gets ``sweeps`` (Dijkstra steps, one column
    scanned each) and ``augment_steps`` (columns reassigned) added to it."""
    c = np.ascontiguousarray(cost.detach().cpu().numpy(), dtype=np.float32)
    R, C = c.shape
    inf = np.float32(np.inf)
    u = np.zeros(R, np.float32)
    v = np.zeros(C, np.float32)
    row4col = np.full(C, -1, np.int32)
    col4row = np.full(R, -1, np.int32)
    rows = np.arange(R)
    sweeps = steps = 0
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
            sweeps += 1

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
            steps += 1
            if i == cur_row:
                break
    if stats is not None:
        stats["sweeps"] = stats.get("sweeps", 0) + sweeps
        stats["augment_steps"] = stats.get("augment_steps", 0) + steps
    return torch.from_numpy(col4row)


def solve(cost: torch.Tensor) -> torch.Tensor:
    """Exact assignment of every problem of a batch: cost [..., R, C] with
    R <= C -> col4row [..., R] int32 (the column of each row).

    A CUDA tensor goes to the kernel that :func:`plan` names, in one launch;
    a CPU tensor to the plain version, one problem after the other."""
    *lead, R, C = cost.shape
    if R > C:
        raise ValueError(f"solve takes R <= C, got [{R}, {C}]: solve the transpose")
    cost = cost.float()
    if cost.device.type == "cpu":
        KERNELS["lap_solve"].plain(cost.dtype)
        flat = cost.reshape(-1, R, C)
        out = torch.stack([_solve_square_leq(c) for c in flat]) if len(flat) else \
            torch.empty((0, R), dtype=torch.int32)
        return out.reshape(*lead, R)
    if cost.device.type != "cuda":
        raise ValueError(f"solve: tensors on {cost.device} have no kernel")
    p = plan(R, C)
    flat = cost.reshape(-1, R, C).contiguous()
    S = flat.shape[0]
    if S > 2 ** 31 - 1:
        raise ValueError(f"solve: {S} problems exceed the grid")
    out = torch.empty((S, R), dtype=torch.int32, device=cost.device)
    if S and R:
        kernel, args = KERNELS["lap_solve"], (flat.data_ptr(), out.data_ptr(), S, R, C, R * C)
        if p.route == "registers":
            kernel.launch(cost.device, cost.dtype, *args, p.K, p.staged_rows,
                          entry="odam_lap_solve_regs")
        else:
            kernel.launch(cost.device, cost.dtype, *args)
        kernel.add("ROUTE_LAUNCHES", at=p.route)
    return out.reshape(*lead, R)


def linear_sum_assignment(cost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal assignment minimizing the total cost of [..., R, C].

    Returns (row_ids [..., K], col_ids [..., K]) int64 with K = min(R, C),
    rows ascending: scipy's contract, batched over leading axes."""
    *lead, R, C = cost.shape
    dev = cost.device
    if R <= C:
        col4row = solve(cost).long()
        return torch.arange(R, device=dev).expand(*lead, R), col4row
    row4col = solve(cost.transpose(-1, -2)).long()
    order = torch.argsort(row4col, dim=-1)
    return (torch.gather(row4col, -1, order),
            torch.arange(C, device=dev).expand(*lead, C).gather(-1, order))


def masked_assignment(cost: torch.Tensor, row_mask: torch.Tensor,
                      col_mask: torch.Tensor) -> torch.Tensor:
    """Assignment over the valid submatrix of padded cost matrices.

    ``cost`` [..., R, C], ``row_mask`` [..., R] and ``col_mask`` [..., C]
    bool.  Invalid slots are priced at 128x the valid-cost span above the
    shifted valid costs (scale-aware, as in the JAX package, whose docstring
    says why a fixed large constant is wrong in float32); an assignment that
    touches an invalid slot is reported as unmatched.  No host sync.

    Returns:
        col4row [..., R] int32: assigned column per row, -1 where unmatched.
    """
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


def match_by_score(score: torch.Tensor, threshold: float | torch.Tensor,
                   row_mask: torch.Tensor | None = None,
                   col_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact decode: LAP on cost = 1 - score, keep matches whose score
    exceeds ``threshold``.  Batched, on the score's device, no host sync.

    Args:
        score: [..., M, N] (tracks x detections) score matrices in [0, 1];
        row_mask [..., M], col_mask [..., N] bool (default all valid).

    Returns:
        [..., N] int32 track index per detection, -1 if unmatched.
    """
    M, N = score.shape[-2:]
    lead, dev = score.shape[:-2], score.device
    if row_mask is None:
        row_mask = torch.ones(lead + (M,), dtype=torch.bool, device=dev)
    if col_mask is None:
        col_mask = torch.ones(lead + (N,), dtype=torch.bool, device=dev)
    col4row = masked_assignment(1.0 - score, row_mask, col_mask)        # column per track
    safe = torch.clamp(col4row, 0, N - 1).long()
    ok = (col4row >= 0) & (torch.gather(score, -1, safe[..., None])[..., 0] > threshold)
    # scatter track ids into their detection slots; rejected rows land on the
    # extra slot N, which is dropped
    idx = torch.where(ok, col4row.long(), N)
    rows = torch.arange(M, dtype=torch.int32, device=dev).expand(lead + (M,))
    out = torch.full(lead + (N + 1,), -1, dtype=torch.int32, device=dev).scatter(-1, idx, rows)
    return torch.where(col_mask, out[..., :N], -1).int()


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
