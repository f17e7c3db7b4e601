"""Numerics of the tensor-core attention kernels, emulated on the CPU.

``odam_torch/csrc/attention.cu`` runs f32 attention as 3xTF32 on the tensor
cores, and splits the keys of each 16-row query tile across the eight warps
of a block, whose softmax states (m, l, acc) merge at the end of the launch.
The kernels run only on the card. Here both parts of the design are emulated
in PyTorch, in the order the kernels take their steps, at the main path's
shapes on numpy-seeded inputs. The emulation is held to ``attention_plain``
and to the JAX package's Pallas kernels in interpret mode (as
tests/test_aux.py runs them), at the kernels' bars: atol 2e-5 (fused) and
3e-5 (flash). Plain TF32 visibly misses those bars. The emulations live in
this file only; nothing on the port's path calls them.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.ops import cuda_attention
from odam_tpu.ops import pallas_attention
from torch_threads import one_torch_thread  # noqa: F401

FUSED_ATOL = 2e-5   # tests/test_aux.py:317
FLASH_ATOL = 3e-5   # tests/test_aux.py:213
ATOL = {"fused": FUSED_ATOL, "flash": FLASH_ATOL}
WARPS = 8           # attention.cu kWarps: warps of a block, which split the keys
FLASH_TILE = 16     # attention.cu kTileK: keys per flash tile; warp w takes w, w+8, ...
FUSED_GROUP = 16    # attention.cu kGroup: fused warps take contiguous runs of groups
LOG2E = 1.4426950408889634
MASKED = -1e9

# chip_smoke.py's main-path calls: (kernel, B, Lq, Lk, H, dh, masked tail or
# None for no mask)
MAIN_PATH = {
    "DETR encoder self": ("flash", 1, 850, 850, 8, 32, 0),
    "DETR decoder cross": ("flash", 1, 100, 850, 8, 32, 0),
    "DETR decoder self": ("fused", 1, 100, 100, 8, 32, None),
    "GNN track self": ("fused", 1, 64, 64, 4, 64, 20),
    "GNN detection self": ("fused", 1, 30, 30, 4, 64, None),
    "GNN track<-detection cross": ("fused", 1, 64, 30, 4, 64, None),
    "GNN detection<-track cross": ("fused", 1, 30, 64, 4, 64, 20),
    # the scene path: the committed rehearsal model on 192x192 frames
    "scene encoder self": ("fused", 1, 144, 144, 4, 16, 0),
    "scene decoder cross": ("fused", 1, 16, 144, 4, 16, 0),
    "scene decoder self": ("fused", 1, 16, 16, 4, 16, None),
    "scene GNN track self": ("fused", 1, 64, 64, 4, 16, 45),
    "scene GNN detection self": ("fused", 1, 30, 30, 4, 16, None),
    "scene GNN track<-detection cross": ("fused", 1, 64, 30, 4, 16, None),
    "scene GNN detection<-track cross": ("fused", 1, 30, 64, 4, 16, 59),
    # the full-width CLI run on frames resized to 800x800
    "cli_full encoder self": ("flash", 1, 625, 625, 8, 32, 0),
    "cli_full decoder cross": ("flash", 1, 100, 625, 8, 32, 0),
}


# ------------------------------------------------------------- 3xTF32

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: the kernel's integer add and mask, as cvt.rna.tf32.f32 rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: lo.hi' + hi.lo' + hi.hi', f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with one TF32 product, as plain TF32 tensor-core math would."""
    return tf32_round(a) @ tf32_round(b)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


# ---------------------------------------------------- split-key softmax

def warp_chunks(kernel: str, Lk: int) -> list[list[tuple[int, int]]]:
    """Per warp of a block, the [start, stop) key ranges it attends to, in
    order. Ranges may run past Lk: the kernel stages those rows as zeros."""
    if kernel == "flash":
        n = -(-Lk // FLASH_TILE)
        return [[(t * FLASH_TILE, (t + 1) * FLASH_TILE) for t in range(w, n, WARPS)]
                for w in range(WARPS)]
    n = -(-Lk // FUSED_GROUP)
    per = -(-n // WARPS)
    chunks = []
    for w in range(WARPS):
        g0, g1 = w * per, min((w + 1) * per, n)
        chunks.append([(g0 * FUSED_GROUP, g1 * FUSED_GROUP)] if g1 > g0 else [])
    return chunks


def warp_state(Q, k, v, padded, chunks, mm):
    """One warp's online softmax, in base 2, over its chunks of keys."""
    Lq, dh = Q.shape
    Lk = k.shape[0]
    scale = LOG2E / math.sqrt(dh)
    m = torch.full((Lq,), -math.inf)
    l = torch.zeros(Lq)
    acc = torch.zeros(Lq, dh)
    for start, stop in chunks:
        keys = torch.arange(start, stop)
        real = keys < Lk
        K = torch.zeros(stop - start, dh)
        V = torch.zeros(stop - start, dh)
        K[real], V[real] = k[keys[real]], v[keys[real]]
        s = mm(Q, K.T) * scale
        pad = torch.zeros(stop - start, dtype=torch.bool)
        pad[real] = padded[keys[real]]
        s[:, pad] = MASKED
        s[:, ~real] = -math.inf          # the ragged edge takes no part
        m_new = torch.maximum(m, s.max(dim=1).values)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[:, None])
        l = l * alpha + p.sum(dim=1)
        acc = acc * alpha[:, None] + mm(p, V)
        m = m_new
    return m, l, acc


def merge(states):
    """The end of the launch: weigh each warp's state by 2^(m - max m); a
    warp that saw no key (m = -inf) weighs 0."""
    M = torch.stack([m for m, _, _ in states]).max(dim=0).values
    L, O = 0.0, 0.0
    for m, l, acc in states:
        a = torch.where(m == -math.inf, 0.0, torch.exp2(m - M))
        L = L + a * l
        O = O + a[:, None] * acc
    return O / L[:, None]


def kernel_emulation(kernel, q, k, v, kpm, mm=mm_3xtf32):
    """[B, Lq, H, dh] f32: what the CUDA kernel computes, step by step."""
    B, Lq, H, dh = q.shape
    Lk = k.shape[1]
    chunks = warp_chunks(kernel, Lk)
    padded = torch.zeros(B, Lk, dtype=torch.bool) if kpm is None else kpm
    out = torch.empty(B, Lq, H, dh)
    for b in range(B):
        for h in range(H):
            states = [warp_state(q[b, :, h], k[b, :, h], v[b, :, h], padded[b], c, mm)
                      for c in chunks]
            out[b, :, h] = merge(states)
    return out


# --------------------------------------------------------------- inputs

def _inputs(seed, B, Lq, Lk, H, dh, tail, all_masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, Lk, H, dh)).astype(np.float32)
    v = rng.normal(size=(B, Lk, H, dh)).astype(np.float32)
    kpm = None
    if tail is not None:
        kpm = np.zeros((B, Lk), bool)
        if tail:
            kpm[:, -tail:] = True
        if all_masked_row:
            kpm[-1] = True
    return q, k, v, kpm


def _pallas(kernel, q, k, v, kpm):
    mask = jnp.asarray(np.zeros(k.shape[:2], bool) if kpm is None else kpm)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    if kernel == "flash":
        return np.asarray(pallas_attention.flash_attention(*args, block_k=256, interpret=True))
    return np.asarray(pallas_attention.fused_attention(*args, interpret=True))


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------- tests

def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, -(one + 2 ** -11), one + 3 * 2 ** -11,
                      0.1, -7.3e-3], dtype=torch.float32)
    hi = tf32_round(x)
    assert hi[:4].tolist() == [one + 2 ** -10, one, -(one + 2 ** -10), one + 2 ** -9]
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + (x - hi) is x exactly, and the truncated lo keeps all but 2^-21 of x
    assert torch.equal(hi + (x - hi), x)
    hi, lo = split(x)
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -21).all()


@pytest.mark.parametrize("case", list(MAIN_PATH))
def test_3xtf32_split_key_emulation_meets_the_bars(case):
    kernel, B, Lq, Lk, H, dh, tail = MAIN_PATH[case]
    q, k, v, kpm = _inputs(Lq * Lk + dh, B, Lq, Lk, H, dh, tail)
    tq, tk, tv, tm = _torch(q, k, v, kpm)
    out = kernel_emulation(kernel, tq, tk, tv, tm).numpy()
    plain = cuda_attention.attention_plain(tq, tk, tv, tm).numpy()
    np.testing.assert_allclose(out, plain, rtol=0, atol=ATOL[kernel])
    np.testing.assert_allclose(out, _pallas(kernel, q, k, v, kpm), rtol=0, atol=ATOL[kernel])


@pytest.mark.parametrize("case", list(MAIN_PATH))
def test_plain_tf32_misses_the_bars(case):
    kernel, B, Lq, Lk, H, dh, tail = MAIN_PATH[case]
    q, k, v, kpm = _inputs(Lq * Lk + dh, B, Lq, Lk, H, dh, tail)
    tq, tk, tv, tm = _torch(q, k, v, kpm)
    plain = cuda_attention.attention_plain(tq, tk, tv, tm)
    err_tf32 = float((kernel_emulation(kernel, tq, tk, tv, tm, mm=mm_tf32) - plain).abs().max())
    err_3x = float((kernel_emulation(kernel, tq, tk, tv, tm) - plain).abs().max())
    assert err_tf32 > 5 * ATOL[kernel], err_tf32
    assert err_3x < err_tf32 / 50, (err_3x, err_tf32)


# (kernel, B, Lq, Lk, H, dh, masked tail, all-masked batch row, what the
# block's warps see)
SPLIT_CASES = {
    "flash Lk 1": ("flash", 1, 37, 1, 2, 32, 0, False, "idle"),
    "flash Lk 33, a ragged tile of one key": ("flash", 1, 20, 33, 2, 16, 0, False, "idle"),
    "flash Lk 64": ("flash", 1, 37, 64, 2, 32, 0, False, "idle"),
    "flash Lk 65, a tile of one padded key": ("flash", 2, 37, 65, 2, 64, 1, False, "padded"),
    "flash Lk 257, a ragged tile of one key": ("flash", 1, 50, 257, 2, 32, 2, False, ""),
    "flash masked tail covers warps 6 and 7": ("flash", 1, 50, 128, 2, 32, 40, False, "padded"),
    "flash all-masked batch row": ("flash", 2, 17, 300, 2, 16, 7, True, "padded"),
    "flash Lq 1": ("flash", 1, 1, 850, 2, 32, 3, False, ""),
    "fused Lk 30": ("fused", 1, 30, 30, 2, 64, None, False, "idle"),
    "fused masked tail covers warps 4 to 6": ("fused", 1, 50, 100, 2, 32, 40, False, "padded"),
    "fused Lk 255": ("fused", 1, 65, 255, 2, 32, 1, False, ""),
    "fused all-masked batch row": ("fused", 2, 37, 100, 2, 64, 5, True, "padded"),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_key_merge_equals_unsplit_softmax(case):
    """The per-warp states merged at the end equal one softmax over all keys,
    with warps that see no key, only ragged keys or only padded keys."""
    kernel, B, Lq, Lk, H, dh, tail, all_masked, sees = SPLIT_CASES[case]
    q, k, v, kpm = _inputs(Lk + Lq, B, Lq, Lk, H, dh, tail, all_masked)
    chunks = warp_chunks(kernel, Lk)
    covered = sorted(i for c in chunks for start, stop in c for i in range(start, min(stop, Lk)))
    assert covered == list(range(Lk))      # every key once, by one warp
    if sees == "idle":
        assert any(not c for c in chunks)
    if sees == "padded":                   # some warp sees keys, all of them padded
        assert any(c and all(kpm[0, start:min(stop, Lk)].all() for start, stop in c)
                   for c in chunks) or all_masked
    tq, tk, tv, tm = _torch(q, k, v, kpm)
    out = kernel_emulation(kernel, tq, tk, tv, tm, mm=mm_f32)
    plain = cuda_attention.attention_plain(tq, tk, tv, tm)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=0, atol=2e-6)
    if all_masked:                          # uniform average over the Lk keys
        uniform = tv[-1].mean(dim=0, keepdim=True).expand(Lq, H, dh)
        np.testing.assert_allclose(out[-1].numpy(), uniform.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("view,aligned", [
    (lambda x: x, True),
    (lambda x: x[:, 1:], True),            # whole rows off: 1 KB further
    (lambda x: x.transpose(1, 2), True),   # strides permuted, still 16-byte multiples
    (lambda x: x[..., 1:17], False),       # pointer 4 bytes off
    (lambda x: x[..., ::2], False),        # the head dim not contiguous
])
def test_wrapper_alignment_rule(view, aligned):
    """cp.async stages K/V in 16-byte copies: the wrapper hands a q, k or v on
    to the kernel as it is only when pointer and strides are 16-byte aligned,
    and copies it (counted in ALIGN_COPIES) otherwise."""
    x = view(torch.zeros(1, 100, 8, 32))
    assert cuda_attention._aligned(x) is aligned
