"""Multi-head attention core shared by the DETR transformer and the associator.

Counterpart of ``odam_tpu/ops/attention.py`` with the same contract and the
same routing: batch-first [B, L, D], heads split head-major [H, dh], a
``key_padding_mask`` [B, Lk] bool with True = padded (logit -1e9).

With ``use_kernels`` (the counterpart of JAX's ``use_pallas``), calls with
B <= ``KERNEL_MAX_BATCH`` go to the attention kernels of
:mod:`odam_torch.ops.cuda_attention` (flash for Lk >= ``FLASH_MIN_KEYS``,
fused below it); larger batches, such as the associator's history fuser at
B = 64 tracks, take the plain path below.  A call that carries ``lanes``
independent scenes stacked on its batch axis (the scene-parallel step)
routes on the batch of one lane, B / lanes: JAX vmaps its step over the
lanes, so each lane's call sees that batch, and the kernels take the whole
stack in one launch.  On a CPU tensor the kernel
wrappers run their plain versions, so the routing is the same on both.
Without it every call takes the plain path, which autograd can
differentiate: the kernels have no backward, so training turns them off.
"""
from __future__ import annotations

import math

import torch

from . import cuda_attention

NEG_INF = -1e9

# Both thresholds were measured on a TPU for the JAX package
# (odam_tpu/ops/attention.py:20-38).  They carry no weight on the card and
# are kept only so that the same calls take the same kernels as in JAX.
FLASH_MIN_KEYS = 256
KERNEL_MAX_BATCH = 2


def mha_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
             key_padding_mask: torch.Tensor | None = None,
             use_kernels: bool = True, lanes: int = 1) -> torch.Tensor:
    """Scaled dot-product attention over heads.

    Args:
        q: [B, Lq, D]; k, v: [B, Lk, D] (already projected).
        num_heads: H; D must be divisible by H.
        key_padding_mask: optional [B, Lk] bool, True = padded (masked out).
        use_kernels: route B / lanes <= KERNEL_MAX_BATCH to the kernel wrappers.
        lanes: scenes stacked on the batch axis; must divide B.

    Returns:
        [B, Lq, D] attention output (before the out projection).
    """
    B, Lq, D = q.shape
    if lanes < 1 or B % lanes:
        raise ValueError(f"lanes {lanes} does not divide the batch {B}")
    Lk = k.shape[1]
    H = num_heads
    dh = D // H
    qh = q.reshape(B, Lq, H, dh)
    kh = k.reshape(B, Lk, H, dh)
    vh = v.reshape(B, Lk, H, dh)

    if use_kernels and B // lanes <= KERNEL_MAX_BATCH:
        if Lk >= FLASH_MIN_KEYS:
            out = cuda_attention.flash_attention(qh, kh, vh, key_padding_mask)
        else:
            out = cuda_attention.fused_attention(qh, kh, vh, key_padding_mask)
        return out.reshape(B, Lq, D)

    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, Lq, D)
