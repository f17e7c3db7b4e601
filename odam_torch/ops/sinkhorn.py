"""Log-space optimal transport with a learned dustbin (Sinkhorn).

Counterpart of ``odam_tpu/ops/sinkhorn.py``: the same math in float32, with
padded rows and columns masked at -1e9.

:func:`log_optimal_transport` on CUDA tensors runs in one launch of the
hand-written kernel of ``odam_torch/csrc/sinkhorn.cu``: one block a problem,
Z and the potentials in shared memory for all the iterations, on the current
stream and with no host read, so it can be captured in a CUDA graph.  The
kernel has no backward, so on CUDA tensors a call that needs a gradient
raises: a model that trains is built with ``use_kernels=False``, and
:class:`odam_torch.models.associator.Associator` then calls
:func:`log_optimal_transport_plain` itself.  On CPU tensors the function
runs the plain version, which autograd differentiates.  Both are counted as
kernel ``sinkhorn`` in group ``sinkhorn`` of :mod:`.kernels` (the library
:data:`.kernels.SINKHORN`), the plain calls only through
:func:`log_optimal_transport`.
"""
from __future__ import annotations

import torch

from .kernels import KERNELS

_NEG = -1e9
_TOO_LARGE = -1                # odam_sinkhorn's code: Z does not fit one block


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


def log_optimal_transport_plain(scores: torch.Tensor, alpha: torch.Tensor, iters: int = 100,
                                row_mask: torch.Tensor | None = None,
                                col_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, which autograd differentiates;
    arguments and result as :func:`log_optimal_transport`'s."""
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


def _launch(scores: torch.Tensor, alpha: torch.Tensor, iters: int,
            row_mask: torch.Tensor | None, col_mask: torch.Tensor | None) -> torch.Tensor:
    *batch, M, N = scores.shape
    if scores.dtype != torch.float32:
        raise ValueError(f"sinkhorn: the kernel takes float32 scores, got {scores.dtype}")
    if alpha.numel() != 1:
        raise ValueError(f"sinkhorn: alpha must be one value, got shape {tuple(alpha.shape)}")
    flat = scores.reshape(-1, M, N).contiguous()
    S = flat.shape[0]
    if S > 2 ** 31 - 1:
        raise ValueError(f"sinkhorn: {S} problems exceed the grid")
    masks = [None if mask is None else
             mask.to(device=scores.device, dtype=torch.bool).expand(*batch, n)
             .reshape(S, n).contiguous() for mask, n in ((row_mask, M), (col_mask, N))]
    a = alpha.to(device=scores.device, dtype=torch.float32).reshape(1).contiguous()
    out = torch.empty((S, M + 1, N + 1), dtype=torch.float32, device=scores.device)
    if S:
        err = KERNELS["sinkhorn"].launch(
            scores.device, scores.dtype, flat.data_ptr(),
            *(0 if m is None else m.data_ptr() for m in masks), a.data_ptr(), out.data_ptr(),
            S, M, N, max(int(iters), 0), returns=(_TOO_LARGE,))
        if err == _TOO_LARGE:
            raise ValueError(f"sinkhorn: the Z [{M + 1}, {N + 1}] of a [{M}, {N}] problem, its "
                             "potentials and marginals do not fit one block's shared memory")
    return out.reshape(*batch, M + 1, N + 1)


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor, iters: int = 100,
                          row_mask: torch.Tensor | None = None,
                          col_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Partial assignment in log space with a dustbin row and column.

    Args:
        scores: [..., M, N]; alpha: scalar dustbin score.
        row_mask / col_mask: optional [..., M] / [..., N] validity.

    Returns:
        [..., M+1, N+1] log assignment, scaled so probabilities are
        multiplied by (m + n).  The kernel on CUDA tensors, where a call
        that needs a gradient raises; the plain version on CPU tensors
        (module docstring).
    """
    if scores.device.type == "cuda":
        if torch.is_grad_enabled() and (scores.requires_grad or alpha.requires_grad):
            raise RuntimeError(
                "the Sinkhorn kernel has no backward: a gradient through it would be cut.  "
                "Build the model with use_kernels=False to train it, or call it under "
                "torch.no_grad()")
        return _launch(scores, alpha, iters, row_mask, col_mask)
    KERNELS["sinkhorn"].plain(scores.dtype)
    return log_optimal_transport_plain(scores, alpha, iters, row_mask, col_mask)
