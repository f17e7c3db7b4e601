"""Hand-written CUDA attention kernels, their wrappers and plain versions.

Counterpart of ``odam_tpu/ops/pallas_attention.py``.  The kernels live in
``odam_torch/csrc/attention.cu`` (see its header for the design and what
bounds them on the card).  Both run Q.K^T and P.V on the tensor cores
(3xTF32 in f32, bf16 with f32 accumulation), a block being one 16-row query
tile whose eight warps split the keys and merge their softmax states:

- :func:`fused_attention` replaces ``pallas_attention.fused_attention``
  (``_attn_kernel``): the keys of a (batch, head) slice in shared memory,
  all at once below 256 keys and in slabs of 256 from there, a one-pass
  softmax a slab with the logits in registers.  Any Lk >= 1, as JAX's.
- :func:`flash_attention` replaces ``pallas_attention.flash_attention``
  (``_flash_kernel``): K/V stream through shared memory in 16-key tiles with
  an online softmax.  Any Lk >= 1; the ragged key edge is masked in the
  kernel, Lk is never padded.

Layout at this boundary is the JAX package's: q [B, Lq, H, dh], k and v
[B, Lk, H, dh], key_padding_mask [B, Lk] bool with True = padded key.
Softmax and accumulation run in f32 and the output has the input dtype
(float32 or bfloat16); dh is 16, 32 or 64.

Neither kernel has a backward, so both wrappers raise, on any device and
before any launch, when grad mode is on and q, k or v requires grad: a
model that trains is built with ``use_kernels=False`` and takes the plain
path of :func:`odam_torch.ops.attention.mha_core`, as JAX trains without
``use_pallas``.

On a CPU tensor a wrapper runs :func:`attention_plain` and counts the call as
a plain call; on a CUDA tensor it launches its kernel or raises.  There is
no fallback from one to the other.  The counts are group ``attention`` of
:mod:`.kernels`, in its layout (by the dtype of q, "float32" or
"bfloat16"), with two extras: ``LAUNCHES_BY_BATCH`` splits a kernel's
launches by their batch B, and ``ALIGN_COPIES`` counts copies: the kernels
stage K/V with 16-byte ``cp.async`` copies, so a q, k or v whose pointer or
strides are not 16-byte aligned is copied first.

The library (:data:`.kernels.ATTENTION`) is built at first use with
``nvcc`` (``-gencode arch=compute_90a,code=sm_90a``) into
``odam_torch/_build/``, keyed by a hash of the sources.
"""
from __future__ import annotations

import torch

from .kernels import KERNELS

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (16, 32, 64)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the same function, in f32.

    A padded key gets the logit -1e9, so an all-padded query row averages V
    uniformly over the Lk keys.
    """
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v.float()).to(q.dtype)


def _check(q, k, v, key_padding_mask) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"expected q [B,Lq,H,dh], k/v [B,Lk,H,dh]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or dh")
    if k.shape[1] < 1:
        raise ValueError("attention needs at least one key")
    if key_padding_mask is not None and (key_padding_mask.dtype != torch.bool or
                                         key_padding_mask.shape != k.shape[:2]):
        raise ValueError("key_padding_mask must be bool [B, Lk]")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "the attention kernels have no backward (neither has the JAX package's Pallas "
            "kernels): a gradient through them would be cut.  Build the model with "
            "use_kernels=False to train it, or call it under torch.no_grad()")


def _aligned(x: torch.Tensor) -> bool:
    """Pointer and the strides of the first three dims 16-byte aligned."""
    sb, sl, sh, sd = x.stride()
    return sd == 1 and (x.data_ptr() | (sb | sl | sh) * x.element_size()) % 16 == 0


def _launch(name: str, q, k, v, key_padding_mask) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {q.device} have no kernel")
    B, Lq, H, dh = q.shape
    Lk = k.shape[1]
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {KERNEL_HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: float32 or bfloat16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if B * H > 65535:
        raise ValueError(f"{name}: B * H = {B * H} exceeds the grid's 65535")
    kernel, qkv = KERNELS[name], []
    for x in (q, k, v):
        if not _aligned(x):
            x = x.clone(memory_format=torch.contiguous_format)
            kernel.add("ALIGN_COPIES")
        qkv.append(x)
    q, k, v = qkv
    if max(x.numel() for x in (q, k, v)) >= 2 ** 31:
        raise ValueError(f"{name}: tensors too large for 32-bit strides")
    mask = None
    if key_padding_mask is not None:
        mask = key_padding_mask.to(q.device).contiguous()
    out = torch.empty((B, Lq, H, dh), dtype=q.dtype, device=q.device)
    kernel.launch(q.device, q.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if mask is None else mask.data_ptr(), out.data_ptr(),
                  0 if q.dtype == torch.float32 else 1, B, H, Lq, Lk, dh,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  0 if mask is None else mask.stride(0))
    kernel.add("LAUNCHES_BY_BATCH", at=B)
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Single-pass softmax attention over slabs of 256 keys: [B, Lq, H, dh] -> [B, Lq, H, dh]."""
    _check(q, k, v, key_padding_mask)
    if q.device.type == "cpu":
        KERNELS["fused_attention"].plain(q.dtype)
        return attention_plain(q, k, v, key_padding_mask)
    return _launch("fused_attention", q, k, v, key_padding_mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Streaming (online-softmax) attention: [B, Lq, H, dh] -> [B, Lq, H, dh]."""
    _check(q, k, v, key_padding_mask)
    if q.device.type == "cpu":
        KERNELS["flash_attention"].plain(q.dtype)
        return attention_plain(q, k, v, key_padding_mask)
    return _launch("flash_attention", q, k, v, key_padding_mask)
