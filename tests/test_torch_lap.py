"""The port's exact assignment (odam_torch/ops/lap.py) against the JAX
package's (odam_tpu/ops/lap.py), on the CPU.

The batched, sync-free ``masked_assignment``, ``match_by_score`` and
``linear_sum_assignment`` run here on the plain solver (the CUDA kernel's
plain version) and must equal JAX's exactly, ties included.  A numpy
emulation of the kernel's warp (lanes over columns, the (value, assigned,
index) key reduced by xor shuffles) must equal the plain solver on
tie-heavy costs.  The kernel itself is held to the plain solver on the card
by ``chip_smoke.py``'s ``lap`` phase.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from odam_torch.models import associator as t_assoc
from odam_torch.ops import lap as t_lap
from odam_tpu.ops import lap as j_lap

_j_masked = jax.jit(jax.vmap(j_lap.masked_assignment))
_j_match = jax.jit(jax.vmap(j_lap.match_by_score, in_axes=(0, None, 0, 0)))


def _costs(kind, S, R, C, rng):
    if kind == "random":
        return rng.normal(size=(S, R, C)).astype(np.float32)
    return rng.integers(0, 4, size=(S, R, C)).astype(np.float32)     # full of ties


def _masks(kind, S, R, C, rng):
    if kind == "random":
        return rng.random((S, R)) < 0.7, rng.random((S, C)) < 0.8
    if kind == "all_masked":
        return np.zeros((S, R), bool), np.zeros((S, C), bool)
    rm, cm = np.zeros((S, R), bool), np.zeros((S, C), bool)        # one valid pair
    rm[np.arange(S), rng.integers(0, R, S)] = True
    cm[np.arange(S), rng.integers(0, C, S)] = True
    return rm, cm


@pytest.mark.parametrize("mask_kind", ["random", "all_masked", "one_valid"])
@pytest.mark.parametrize("cost_kind", ["random", "ties"])
@pytest.mark.parametrize("R,C", [(7, 12), (12, 7), (64, 30), (30, 64)])
def test_masked_assignment_equals_jax(R, C, cost_kind, mask_kind):
    rng = np.random.default_rng(R * 100 + C)
    cost = _costs(cost_kind, 3, R, C, rng)
    rm, cm = _masks(mask_kind, 3, R, C, rng)
    want = np.asarray(_j_masked(jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm)))
    got = t_lap.masked_assignment(torch.from_numpy(cost), torch.from_numpy(rm),
                                  torch.from_numpy(cm))
    assert got.dtype == torch.int32 and got.shape == (3, R)
    np.testing.assert_array_equal(got.numpy(), want)
    if mask_kind == "all_masked":
        assert (want == -1).all()
    # one problem at a time (no leading axis) gives the same
    np.testing.assert_array_equal(t_lap.masked_assignment(
        torch.from_numpy(cost[1]), torch.from_numpy(rm[1]), torch.from_numpy(cm[1])).numpy(),
        want[1])


@pytest.mark.parametrize("cost_kind", ["random", "ties"])
def test_match_by_score_decode_shape_equals_jax(cost_kind):
    """The associator's decode: [B, 64 tracks, 30 detections] scores."""
    rng = np.random.default_rng(3)
    B, T, N = 4, 64, 30
    score = (rng.random((B, T, N)) if cost_kind == "random"
             else rng.integers(0, 3, (B, T, N)) / 2.0).astype(np.float32)
    rm, cm = rng.random((B, T)) < 0.6, rng.random((B, N)) < 0.7
    rm[0], cm[1] = False, False                                   # nothing to match
    want = np.asarray(_j_match(jnp.asarray(score), 0.2, jnp.asarray(rm), jnp.asarray(cm)))
    got = t_lap.match_by_score(torch.from_numpy(score), 0.2, torch.from_numpy(rm),
                               torch.from_numpy(cm))
    assert got.dtype == torch.int32 and got.shape == (B, N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] == -1).all() and (want[1] == -1).all() and (want >= 0).any()


@pytest.mark.parametrize("M", [3, 20])
def test_matcher_shape_equals_jax(M):
    """The training matcher's problems: [100 queries, M targets], every row
    valid and some targets padded (its transposed branch)."""
    rng = np.random.default_rng(M)
    S, Q = 6, 100
    cost = (rng.normal(size=(S, Q, M)) * 3).astype(np.float32)
    rm = np.ones((S, Q), bool)
    cm = rng.random((S, M)) < 0.8
    want = np.asarray(_j_masked(jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm)))
    got = t_lap.masked_assignment(torch.from_numpy(cost), torch.from_numpy(rm),
                                  torch.from_numpy(cm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((want >= 0).sum(-1) == cm.sum(-1)).all()      # every valid target matched once


@pytest.mark.parametrize("cost_kind", ["random", "ties"])
@pytest.mark.parametrize("R,C", [(9, 15), (15, 9), (16, 16)])
def test_linear_sum_assignment_equals_jax_and_scipy(R, C, cost_kind):
    rng = np.random.default_rng(R + C)
    cost = _costs(cost_kind, 2, R, C, rng)
    rows, cols = t_lap.linear_sum_assignment(torch.from_numpy(cost))
    assert rows.shape == cols.shape == (2, min(R, C))
    for s in range(2):
        jr, jc = j_lap.linear_sum_assignment(jnp.asarray(cost[s]))
        np.testing.assert_array_equal(rows[s].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(cols[s].numpy(), np.asarray(jc))
        r1, c1 = t_lap.linear_sum_assignment(torch.from_numpy(cost[s]))
        np.testing.assert_array_equal(r1.numpy(), rows[s].numpy())
        np.testing.assert_array_equal(c1.numpy(), cols[s].numpy())
        sr, sc = scipy_lsa(cost[s])
        assert np.all(np.diff(rows[s].numpy()) > 0)
        np.testing.assert_allclose(cost[s][rows[s].numpy(), cols[s].numpy()].sum(),
                                   cost[s][sr, sc].sum(), rtol=1e-5, atol=1e-5)


def test_solve_takes_r_at_most_c():
    with pytest.raises(ValueError, match="R <= C"):
        t_lap.solve(torch.zeros(5, 3))
    assert t_lap.solve(torch.zeros(0, 4, 6)).shape == (0, 4)


# ------------------------------------------------ the kernel's warp, emulated

WARP = 32


def _key_less(a, b):
    """lap.cu's key_less on (value, assigned, index) triples."""
    if a[0] < b[0]:
        return True
    if b[0] < a[0]:
        return False
    if a[1] != b[1]:
        return a[1] < b[1]
    return a[2] < b[2]


def _warp_solve(cost: np.ndarray) -> np.ndarray:
    """lap_kernel step for step in numpy: lane l holds columns l, l + 32, ...,
    keeps its own least key, and the warp reduces the 32 keys with xor
    shuffles at offsets 16, 8, 4, 2, 1."""
    R, C = cost.shape
    f = np.float32
    u, v = np.zeros(R, f), np.zeros(C, f)
    row4col, col4row = np.full(C, -1), np.full(R, -1)
    for cur in range(R):
        spc, path = np.full(C, np.inf, f), np.full(C, -1)
        sc, sr = np.zeros(C, bool), np.zeros(R, bool)
        i, sink, min_val = cur, -1, f(0)
        while sink < 0:
            sr[i] = True
            keys = []
            for lane in range(WARP):
                best = (f(np.inf), 2, 2 ** 31 - 1)
                for j in range(lane, C, WARP):
                    if sc[j]:
                        continue
                    r = f(f(f(min_val + cost[i, j]) - u[i]) - v[j])
                    if r < spc[j]:
                        spc[j], path[j] = r, i
                    key = (spc[j], int(row4col[j] >= 0), j)
                    if _key_less(key, best):
                        best = key
                keys.append(best)
            off = WARP // 2
            while off:
                keys = [keys[lane ^ off] if _key_less(keys[lane ^ off], keys[lane])
                        else keys[lane] for lane in range(WARP)]
                off //= 2
            assert len(set(keys)) == 1           # every lane ends with the warp's key
            bv, _, j = keys[0]
            sc[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
            min_val = bv
        for r in range(R):
            if r == cur:
                u[r] = f(u[r] + min_val)
            elif sr[r]:
                u[r] = f(f(u[r] + min_val) - spc[min(max(col4row[r], 0), C - 1)])
        for j in range(C):
            if sc[j]:
                v[j] = f(v[j] - f(min_val - spc[j]))
        j = sink
        while True:
            r = path[j]
            row4col[j] = r
            prev = col4row[r]
            col4row[r] = j
            j = prev
            if r == cur:
                break
    return col4row


@pytest.mark.parametrize("seed,R,C,top", [(0, 12, 70, 2), (1, 20, 40, 3), (2, 16, 16, 1),
                                          (3, 10, 33, 0)])
def test_warp_reduction_equals_plain_solver_on_ties(seed, R, C, top):
    """Integer costs in [0, top] (top 0: every cost equal, every column a
    tie) and C above 32, so lanes hold several columns: the emulated warp
    picks the plain solver's column at every step."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, top + 1, size=(R, C)).astype(np.float32)
    want = t_lap._solve_square_leq(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(_warp_solve(cost), want)
    np.testing.assert_array_equal(
        want, np.asarray(j_lap.linear_sum_assignment(jnp.asarray(cost))[1]))


# ------------------------------------------------------------- the decode site

def test_associator_decode_batched_without_host_reads(monkeypatch):
    """Associator._decode solves all B frames in one call of lap.solve,
    equal to JAX's vmapped decode, and reads nothing back: .cpu(), .item(),
    .tolist(), .numpy() and bool() of a tensor raise outside the solver."""
    rng = np.random.default_rng(11)
    B, T, N = 3, 64, 30
    logits = rng.normal(size=(B, T + 1, N + 1)).astype(np.float32)
    Z = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    tm, dm = rng.random((B, T)) < 0.5, rng.random((B, N)) < 0.8
    want = np.asarray(_j_match(jnp.exp(jnp.asarray(Z.numpy())[:, :-1, :-1]), 0.01,
                               jnp.asarray(tm), jnp.asarray(dm)))
    model = t_assoc.Associator(t_assoc.AssociatorConfig(descriptor_dim=32,
                                                        keypoint_encoder=(32,)))
    real_solve, real = t_lap.solve, {}
    shapes = []

    def forbidden(*_a, **_k):
        raise AssertionError("a host read around the solver")

    def solve(cost):
        shapes.append(tuple(cost.shape))
        for name, fn in real.items():                # the plain solver reads its input
            setattr(torch.Tensor, name, fn)
        try:
            return real_solve(cost)
        finally:
            for name in real:
                setattr(torch.Tensor, name, forbidden)

    for name in ("cpu", "item", "tolist", "numpy", "__bool__"):
        real[name] = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    monkeypatch.setattr(t_lap, "solve", solve)
    got = model._decode(Z, torch.from_numpy(tm), torch.from_numpy(dm), 0.01)
    monkeypatch.undo()
    assert shapes == [(B, N, T)]                  # one call, the transposed [30, 64] problems
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(B):                            # frame by frame, as the decode ran before
        np.testing.assert_array_equal(
            t_lap.match_by_score(torch.exp(Z[b, :-1, :-1]), 0.01, torch.from_numpy(tm[b]),
                                 torch.from_numpy(dm[b])).numpy(), want[b])
