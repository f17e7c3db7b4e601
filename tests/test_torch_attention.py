"""odam_torch attention against odam_tpu: the plain versions of the two CUDA
kernels and ``mha_core``'s routing, on the CPU.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them to these plain versions there.  Here the plain versions are held to the
JAX package's ``mha_core`` and to its Pallas kernels in interpret mode, at
the bars of tests/test_aux.py: atol 2e-5 (fused) and 3e-5 (flash) in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.ops import attention as t_attn
from odam_torch.ops import cuda_attention, kernels
from odam_tpu.ops import attention as j_attn
from odam_tpu.ops import pallas_attention
from torch_threads import one_torch_thread  # noqa: F401

FUSED_ATOL = 2e-5   # tests/test_aux.py:317
FLASH_ATOL = 3e-5   # tests/test_aux.py:213


def _inputs(seed, B, Lq, Lk, H, dh, n_masked):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H * dh)).astype(np.float32)
    k = rng.normal(size=(B, Lk, H * dh)).astype(np.float32)
    v = rng.normal(size=(B, Lk, H * dh)).astype(np.float32)
    kpm = np.zeros((B, Lk), bool)
    if n_masked:
        kpm[:, -n_masked:] = True
    return q, k, v, kpm


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
@pytest.mark.parametrize("Lk,n_masked", [(24, 0), (24, 5), (100, 9)])
def test_fused_plain_matches_pallas_fused(dh, Lk, n_masked):
    B, Lq, H = 2, 16, 2
    q, k, v, kpm = _inputs(dh + Lk, B, Lq, Lk, H, dh, n_masked)
    shape_q, shape_k = (B, Lq, H, dh), (B, Lk, H, dh)
    ref = pallas_attention.fused_attention(
        jnp.asarray(q).reshape(shape_q), jnp.asarray(k).reshape(shape_k),
        jnp.asarray(v).reshape(shape_k), jnp.asarray(kpm), interpret=True)
    out = cuda_attention.attention_plain(
        torch.from_numpy(q).reshape(shape_q), torch.from_numpy(k).reshape(shape_k),
        torch.from_numpy(v).reshape(shape_k), torch.from_numpy(kpm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FUSED_ATOL)


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
@pytest.mark.parametrize("Lk,n_masked", [(300, 7), (850, 0)])
def test_flash_plain_matches_pallas_flash(dh, Lk, n_masked):
    """Lk not a multiple of the TPU kernel's 256-key block, masked tails."""
    B, Lq, H = 1, 8, 2
    q, k, v, kpm = _inputs(dh + Lk, B, Lq, Lk, H, dh, n_masked)
    shape_q, shape_k = (B, Lq, H, dh), (B, Lk, H, dh)
    ref = pallas_attention.flash_attention(
        jnp.asarray(q).reshape(shape_q), jnp.asarray(k).reshape(shape_k),
        jnp.asarray(v).reshape(shape_k), jnp.asarray(kpm), block_k=256, interpret=True)
    out = cuda_attention.attention_plain(
        torch.from_numpy(q).reshape(shape_q), torch.from_numpy(k).reshape(shape_k),
        torch.from_numpy(v).reshape(shape_k), torch.from_numpy(kpm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL)


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("Lk,expect", [(300, "flash_attention"), (100, "fused_attention")])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_mha_core_routing_and_parity(B, Lk, expect, dh):
    """B <= 2 takes the kernel wrappers (flash for Lk >= 256, fused below),
    B = 3 the plain path, as in JAX; all match JAX's plain mha_core."""
    H, Lq = 2, 12
    q, k, v, kpm = _inputs(B * Lk + dh, B, Lq, Lk, H, dh, 9)
    ref = j_attn.mha_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, jnp.asarray(kpm))
    kernels.zero_counts()
    out = t_attn.mha_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
                          torch.from_numpy(kpm))
    if B <= t_attn.KERNEL_MAX_BATCH:
        want = {name: int(name == expect) for name in kernels.KERNELS}
    else:
        want = {name: 0 for name in kernels.KERNELS}
    assert kernels.counts("PLAIN_CALLS") == want
    assert kernels.counts("LAUNCHES") == {name: 0 for name in kernels.KERNELS}
    atol = FLASH_ATOL if Lk >= t_attn.FLASH_MIN_KEYS else FUSED_ATOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("Lk", [100, 300])
def test_all_masked_row_follows_plain_path(Lk):
    """A batch row whose keys are all padded averages V uniformly over its Lk
    keys, as JAX's plain mha_core does.  The TPU flash kernel also averages
    over its pad block there; the port follows the plain path."""
    B, Lq, H, dh = 2, 4, 2, 16
    q, k, v, kpm = _inputs(Lk, B, Lq, Lk, H, dh, 3)
    kpm[1] = True
    ref = j_attn.mha_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, jnp.asarray(kpm))
    out = t_attn.mha_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H,
                          torch.from_numpy(kpm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FLASH_ATOL)
    uniform = v[1].reshape(Lk, H * dh).mean(axis=0)
    np.testing.assert_allclose(out.numpy()[1], np.broadcast_to(uniform, (Lq, H * dh)),
                               atol=1e-5)
    if Lk >= t_attn.FLASH_MIN_KEYS:
        tpu = pallas_attention.flash_attention(
            jnp.asarray(q).reshape(B, Lq, H, dh), jnp.asarray(k).reshape(B, Lk, H, dh),
            jnp.asarray(v).reshape(B, Lk, H, dh), jnp.asarray(kpm), block_k=256,
            interpret=True)
        assert np.abs(np.asarray(tpu)[1].reshape(Lq, -1) - out.numpy()[1]).max() > 1e-3


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        cuda_attention.fused_attention(q, torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError):
        cuda_attention.flash_attention(q, q, q, torch.zeros(1, 4, dtype=torch.int64))
    with pytest.raises(ValueError):   # no kernel for a tensor that is not on the CPU or card
        cuda_attention._launch("fused_attention", q.to("meta"), q.to("meta"), q.to("meta"),
                               None)
