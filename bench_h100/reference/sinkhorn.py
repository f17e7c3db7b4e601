# Frozen copy of the parts of odam_torch/ops/sinkhorn.py
# that the benchmark's plain reference uses; it imports nothing of odam_torch.
"""Log-space optimal transport with a learned dustbin (Sinkhorn).

Counterpart of ``odam_tpu/ops/sinkhorn.py``: the same math in float32, with
padded rows and columns masked at -1e9.
"""
from __future__ import annotations

import torch

_NEG = -1e9


def log_sinkhorn(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Sinkhorn normalization in log space.

    Args:
        Z: [..., M+1, N+1]; log_mu: [..., M+1]; log_nu: [..., N+1].
    """
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[..., None, :], dim=-1)
        v = log_nu - torch.logsumexp(Z + u[..., :, None], dim=-2)
    return Z + u[..., :, None] + v[..., None, :]


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor, iters: int = 100,
                          row_mask: torch.Tensor | None = None,
                          col_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Partial assignment in log space with a dustbin row and column.

    Args:
        scores: [..., M, N]; alpha: scalar dustbin score.
        row_mask / col_mask: optional [..., M] / [..., N] validity.

    Returns:
        [..., M+1, N+1] log assignment, scaled so probabilities are
        multiplied by (m + n).
    """
    m, n = scores.shape[-2], scores.shape[-1]
    batch = scores.shape[:-2]
    dev = scores.device
    if row_mask is None:
        row_mask = torch.ones(batch + (m,), dtype=torch.bool, device=dev)
    if col_mask is None:
        col_mask = torch.ones(batch + (n,), dtype=torch.bool, device=dev)
    row_mask = row_mask.bool()
    col_mask = col_mask.bool()
    alpha = alpha.to(scores.dtype)

    ms = row_mask.sum(-1).to(scores.dtype)
    ns = col_mask.sum(-1).to(scores.dtype)
    pair_mask = row_mask[..., :, None] & col_mask[..., None, :]
    scores = torch.where(pair_mask, scores, _NEG)

    bins0 = torch.where(row_mask, alpha, _NEG)[..., :, None]
    bins1 = torch.where(col_mask, alpha, _NEG)[..., None, :]
    corner = alpha.expand(batch + (1, 1))
    Z = torch.cat([torch.cat([scores, bins0], dim=-1),
                   torch.cat([bins1, corner], dim=-1)], dim=-2)

    norm = -torch.log(ms + ns)[..., None]
    log_mu = torch.cat([torch.where(row_mask, norm, _NEG), torch.log(ns)[..., None] + norm],
                       dim=-1)
    log_nu = torch.cat([torch.where(col_mask, norm, _NEG), torch.log(ms)[..., None] + norm],
                       dim=-1)
    Z = log_sinkhorn(Z, log_mu, log_nu, iters)
    return Z - norm[..., None]
