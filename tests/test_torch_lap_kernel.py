"""The registers route of the port's LAP kernel (odam_torch/csrc/lap.cu:
lap_regs_kernel), emulated in numpy on the CPU, against the plain solver
(odam_torch/ops/lap.py:_solve_square_leq) and JAX's (odam_tpu/ops/lap.py).

The emulation keeps the kernel's layout and order of work: lane l owns
columns l + 32k (k < K from ``lap.plan``) as [K, 32] arrays, ragged lanes
masked as scanned; each lane's least spc as an order-preserving uint32, the
warp's least by a first ``__reduce_min_sync``, the column by a second over
(assigned << 30 | index); the dual update column by column (the potential of
a column's row rides with the column); the augmentation walk by the whole
warp, with col4row held by rows l + 32k.  Its assignments must equal the
plain solver's and JAX's at every K boundary and on ties, negative costs,
-0.0 and the all-masked problems ``masked_assignment`` prices.  The kernel
itself is held to the plain solver on the card by ``chip_smoke.py``'s
``lap`` phase.  Also: ``lap.plan`` and the plain solver's sweep counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.ops import lap as t_lap
from odam_tpu.ops import lap as j_lap
from torch_threads import one_torch_thread  # noqa: F401

WARP = 32
NONE = 0xFFFFFFFF
ASSIGNED = 1 << 30
F = np.float32


def order_key(x) -> np.ndarray:
    """lap.cu's order_key: float32 -> uint32 with the same order, -0 as +0."""
    b = np.asarray(x, F).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def order_value(k) -> np.float32:
    """lap.cu's order_value: the float of a key."""
    k = int(k)
    bits = k & 0x7FFFFFFF if k & 0x80000000 else ~k & 0xFFFFFFFF
    return np.array(bits, np.uint32).view(F)[()]


def kernel_emulation(cost: np.ndarray) -> np.ndarray:
    """lap_regs_kernel<K> on one [R, C] problem, step for step."""
    R, C = cost.shape
    K = t_lap.plan(R, C).K
    j_of = np.arange(WARP)[None, :] + WARP * np.arange(K)[:, None]      # [K, 32]: column
    pad = j_of >= C
    col = np.minimum(j_of, C - 1)
    v, ucol = np.zeros((K, WARP), F), np.zeros((K, WARP), F)
    r4c, c4r = np.full((K, WARP), -1), np.full((K, WARP), -1)         # c4r[k, l]: row l + 32k
    for cur in range(R):
        sc = pad.copy()
        spc, path = np.full((K, WARP), np.inf, F), np.full((K, WARP), -1)
        i, ui, min_val = cur, F(0), F(0)
        for it in range(C + 1):
            assert it < C
            r = ((min_val + cost[i][col]) - ui) - v
            better = ~sc & (r < spc)
            spc, path = np.where(better, r, spc), np.where(better, i, path)
            key = np.where(sc, np.uint32(NONE), order_key(spc))
            low = int(key.min(axis=0).min())                 # each lane's least, then the warp's
            assert low != NONE
            cand = np.where(key == low, np.where(r4c >= 0, ASSIGNED, 0) | j_of, NONE)
            pick = int(cand.min(axis=0).min())
            j = pick & (ASSIGNED - 1)
            kb, owner = divmod(j, WARP)
            min_val = order_value(low)
            sc[kb, owner] = True
            if not pick & ASSIGNED:
                break
            i, ui = r4c[kb, owner], ucol[kb, owner]          # two shuffles from the owner
        scanned = sc & ~pad
        ucol = np.where(scanned & (r4c >= 0), (ucol + min_val) - spc, ucol)
        v = np.where(scanned, v - (min_val - spc), v)
        u_cur = F(0) + min_val
        for step in range(R + 1):
            assert step <= R
            kb, owner = divmod(j, WARP)
            r = path[kb, owner]
            prev = c4r[divmod(r, WARP)]
            ur = u_cur if r == cur else ucol[divmod(prev, WARP)]
            r4c[kb, owner], ucol[kb, owner] = r, ur
            c4r[divmod(r, WARP)] = j
            j = prev
            if r == cur:
                break
    return c4r.reshape(-1)[:R]


def _negative_zeros(rng, R, C):
    """Integer costs in -2..2 whose zeros are half -0.0, half +0.0."""
    c = rng.integers(-2, 3, size=(R, C)).astype(F)
    c[(c == 0) & (rng.random((R, C)) < 0.5)] = F(-0.0)
    return c


def _priced(rng, R, C, row_p, col_p):
    """The cost masked_assignment hands to solve: masked slots at 128 x
    the valid span (every slot, when nothing is valid)."""
    score = rng.random((R, C)).astype(F)
    rm, cm = rng.random(R) < row_p, rng.random(C) < col_p
    seen, real = [], t_lap.solve
    t_lap.solve = lambda cost: seen.append(cost) or real(cost)
    try:
        t_lap.masked_assignment(torch.from_numpy(1 - score), torch.from_numpy(rm),
                                torch.from_numpy(cm))
    finally:
        t_lap.solve = real
    return seen[0].numpy()


CASES = {      # name -> cost maker; C at every K boundary and past them
    "C31 every cost equal": lambda rng: np.zeros((31, 31), F),
    "C32 ties 0..1": lambda rng: rng.integers(0, 2, size=(20, 32)).astype(F),
    "C33 ties 0..2": lambda rng: rng.integers(0, 3, size=(33, 33)).astype(F),
    "C64 ties 0..3 (the decode's width)": lambda rng: rng.integers(0, 4, size=(30, 64)).astype(F),
    "C65 negative normal": lambda rng: rng.normal(size=(65, 65)).astype(F) - 2,
    "C100 the matcher's width, -0.0": lambda rng: _negative_zeros(rng, 8, 100),
    "C128 -0.0 and +0.0": lambda rng: _negative_zeros(rng, 100, 128),
    "C129 ties 0..1": lambda rng: rng.integers(0, 2, size=(129, 129)).astype(F),
    "C256 normal": lambda rng: rng.normal(size=(256, 256)).astype(F),
    "C64 decode priced, masked rows": lambda rng: _priced(rng, 30, 64, 0.6, 0.7),
    "C64 decode priced, all masked": lambda rng: _priced(rng, 30, 64, 0.0, 0.0),
}


@pytest.fixture(scope="module")
def solved():
    """Each case's cost, the plain solver's col4row and JAX's."""
    j_solve = jax.jit(j_lap._solve_square_leq)
    out = {}
    for n, (name, make) in enumerate(CASES.items()):
        cost = make(np.random.default_rng(n))
        out[name] = (cost, t_lap._solve_square_leq(torch.from_numpy(cost)).numpy(),
                     np.asarray(j_solve(jnp.asarray(cost))))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernel_equals_plain_solver_and_jax(solved, name):
    cost, plain, jax_col4row = solved[name]
    np.testing.assert_array_equal(plain, jax_col4row)
    np.testing.assert_array_equal(kernel_emulation(cost), plain)
    assert sorted(plain) == sorted(set(plain)) and plain.min() >= 0   # a column a row


def test_order_key_is_monotone_and_below_the_sentinel():
    x = np.array([-np.inf, -3.4e38, -1.0, -1e-38, -1e-45, -0.0, 0.0, 1e-45, 1e-38, 1.0,
                  3.4e38, np.inf], F)
    assert np.all(np.diff(x[x != 0]) > 0)
    k = order_key(x).astype(np.int64)
    assert np.all(np.diff(k)[[i for i in range(len(x) - 1) if i != 5]] > 0)
    assert k[5] == k[6]                                  # -0 ranks with +0
    assert k.max() < NONE
    for val, key in zip(x, k):
        assert order_value(key) == val
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, size=4000, dtype=np.uint64).astype(np.uint32)
    y = bits.view(F)
    y = np.sort(y[~np.isnan(y)])
    assert np.all(np.diff(order_key(y).astype(np.int64)) >= 0)


def _sizes():
    for C in list(range(1, 300)) + [400, 1000, 4096, 8191, 13000, 13654, 13680, 14000]:
        yield from {(R, C) for R in (1, (C + 1) // 2, C)}


def test_plan_takes_every_size_the_shared_kernel_took():
    for R, C in _sizes():
        fits = t_lap.smem_bytes(R, C) <= t_lap.SMEM_LIMIT
        if not fits:
            assert C > 256
            continue
        p = t_lap.plan(R, C)
        assert p.smem_bytes <= t_lap.SMEM_LIMIT
        if C <= 256:
            assert p.route == "registers" and 32 * p.K >= C
            assert p.K == min(k for k in t_lap.REGISTER_K if 32 * k >= C)
            assert p.staged == (4 * R * C <= t_lap.SMEM_LIMIT) == (p.staged_rows == R)
            assert 4 * p.staged_rows * C <= p.smem_bytes <= t_lap.SMEM_LIMIT
        else:
            assert p == ("shared", 0, t_lap.smem_bytes(R, C), 0, False)
    assert t_lap.plan(227, 256).staged and t_lap.plan(227, 256).smem_bytes == t_lap.SMEM_LIMIT
    assert t_lap.plan(256, 256).staged_rows == 227


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="R <= C"):
        t_lap.plan(5, 3)
    for R, C in _sizes():
        if t_lap.smem_bytes(R, C) > t_lap.SMEM_LIMIT:
            need = t_lap.smem_bytes(R, C)
            with pytest.raises(ValueError, match=f"a \\[{R}, {C}\\] problem needs {need} bytes "
                                                 "of shared memory, above the 232448 a block "
                                                 "may use"):
                t_lap.plan(R, C)


def test_plain_solver_counts_sweeps_without_changing_the_answer(solved):
    for name in ("C33 ties 0..2", "C256 normal"):
        cost, plain, _ = solved[name]
        stats: dict = {}
        got = t_lap._solve_square_leq(torch.from_numpy(cost), stats).numpy()
        np.testing.assert_array_equal(got, plain)
        R = cost.shape[0]
        assert R <= stats["augment_steps"] <= stats["sweeps"]
        once = dict(stats)
        t_lap._solve_square_leq(torch.from_numpy(cost), stats)
        assert stats == {k: 2 * n for k, n in once.items()}
    st: dict = {}
    t_lap._solve_square_leq(torch.from_numpy(CASES["C31 every cost equal"](None)), st)
    assert st == {"sweeps": 31, "augment_steps": 31}      # each row straight to a free column
