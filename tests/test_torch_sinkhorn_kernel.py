"""The port's Sinkhorn kernel (odam_torch/csrc/sinkhorn.cu: sinkhorn_kernel),
emulated in numpy on the CPU, against the plain version
(odam_torch/ops/sinkhorn.py:log_optimal_transport_plain) and JAX's
(odam_tpu/ops/sinkhorn.py); the routing of ``log_optimal_transport`` and of
the associator's transport, and the counters.

The emulation keeps the kernel's float32 arithmetic and its order of
reduction: Z, the counts and the marginals built as the kernel builds them;
in each pass a line (a row, then a column) reduced by a group of
``group(lines)`` lanes (the kernel's ``group_for``), lane p taking the elements
p, p + group, ... in that order (fmaxf for the max, sums from 0), then xor
shuffles at offsets group / 2 down to 1; the max replaced by 0 where it is
+-inf, as ATen's logsumexp does.  Live entries must equal the plain version's
and JAX's to float32 rounding, the masked ones (near -1e9) to their
relative rounding, and the -inf and NaN entries exactly: an empty store, a
frame with no detections, both at once, at 0, 1, 3 and 100 iterations.

The ``h100`` tests hold the kernel itself to the plain version on the card
and its replay from a CUDA graph to its eager launch, and check its
refusals (a gradient, a problem one block cannot hold); they skip without a
card.  On a machine with a card and without JAX (which the CPU tests'
reference and ``tests/conftest.py`` import; the card tests import neither)::

    python3 -m pytest tests/test_torch_sinkhorn_kernel.py -m h100 --noconftest -p no:cacheprovider
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from odam_torch.models import associator as t_assoc
from odam_torch.ops import kernels
from odam_torch.ops import sinkhorn as t_sink
from odam_torch.utils import metrics
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32
NEG = F(-1e9)
ALPHA = 1.3
ITERS = (0, 1, 3, 100)
# Live entries reach ~20, where a float32 unit is 1.9e-6: sums of up to 65
# terms taken in another order, and logf and expf of another library, leave
# them up to 2 units apart (3.8e-6, at every iteration count); 1e-5 is ~5.
LIVE_ATOL = 1e-5
MASKED_RTOL = 1e-6           # entries near -1e9: a unit there is 64


def group(lines: int) -> int:
    """sinkhorn.cu's group_for: the largest power of two up to 32 with a
    group of the block's 1024 threads for each line."""
    return min(32, 1 << max(0, (1024 // lines).bit_length() - 1))


def lse_emulation(x: np.ndarray, group: int) -> np.ndarray:
    """sinkhorn.cu's lse_pass over the last axis of ``x`` (float32): a group
    of ``group`` lanes a line, lane p over elements p, p + group, ..."""
    K = x.shape[-1]
    T = -(-K // group)
    pad = np.full(x.shape[:-1] + (T * group,), -np.inf, F)
    pad[..., :K] = x
    lanes = pad.reshape(x.shape[:-1] + (T, group))               # [..., t, p]: element t g + p
    live = (np.arange(T)[:, None] * group + np.arange(group)[None, :]) < K
    m = np.full(x.shape[:-1] + (group,), -np.inf, F)
    for t in range(T):
        m = np.where(live[t], np.fmax(m, lanes[..., t, :]), m)
    p = np.arange(group)
    off = group // 2
    while off:
        m = np.fmax(m, m[..., p ^ off])
        off //= 2
    m = np.where(np.abs(m) == np.inf, F(0), m)                   # ATen's logsumexp
    s = np.zeros(x.shape[:-1] + (group,), F)
    with np.errstate(invalid="ignore", over="ignore"):
        for t in range(T):
            s = np.where(live[t], s + np.exp(lanes[..., t, :] - m), s)
        off = group // 2
        while off:
            s = s + s[..., p ^ off]
            off //= 2
    with np.errstate(divide="ignore", invalid="ignore"):
        return (np.log(s[..., 0]) + m[..., 0]).astype(F)


def kernel_emulation(scores: np.ndarray, alpha: float, iters: int, row_mask: np.ndarray,
                     col_mask: np.ndarray) -> np.ndarray:
    """sinkhorn_kernel on [S, M, N] problems, step for step in float32."""
    S, M, N = scores.shape
    a = F(alpha)
    ms = row_mask.sum(-1).astype(F)
    ns = col_mask.sum(-1).astype(F)
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = -np.log(ms + ns)
        log_mu = np.concatenate([np.where(row_mask, norm[:, None], NEG),
                                 (np.log(ns) + norm)[:, None]], -1).astype(F)
        log_nu = np.concatenate([np.where(col_mask, norm[:, None], NEG),
                                 (np.log(ms) + norm)[:, None]], -1).astype(F)
    rm = np.concatenate([row_mask, np.ones((S, 1), bool)], -1)      # the dustbins are valid
    cm = np.concatenate([col_mask, np.ones((S, 1), bool)], -1)
    Z = np.full((S, M + 1, N + 1), a, F)
    Z[:, :M, :N] = scores
    Z = np.where(rm[:, :, None] & cm[:, None, :], Z, NEG).astype(F)
    u, v = np.zeros((S, M + 1), F), np.zeros((S, N + 1), F)
    with np.errstate(invalid="ignore"):
        for _ in range(iters):
            u = log_mu - lse_emulation(Z + v[:, None, :], group(M + 1))
            v = log_nu - lse_emulation(np.swapaxes(Z + u[:, :, None], 1, 2), group(N + 1))
        return ((Z + u[:, :, None]) + v[:, None, :]) - norm[:, None, None]


def _masks(rng, S, M, N, rows, cols):
    """Row and column masks with the first ``rows[s]`` / ``cols[s]`` valid."""
    rows, cols = np.broadcast_to(rows, S), np.broadcast_to(cols, S)
    return np.arange(M)[None] < rows[:, None], np.arange(N)[None] < cols[:, None]


def _lane(rng):
    """The lane step's problem: 16 lanes, 64 track slots of which 48 are
    filled in most lanes, 30 detection slots, scores as the GNN gives them."""
    S, M, N = 16, 64, 30
    rows = np.where(rng.random(S) < 0.25, rng.integers(0, 64, S), 48)
    rm, cm = _masks(rng, S, M, N, rows, rng.integers(1, 31, S))
    return rng.normal(size=(S, M, N)).astype(F) * 3, rm, cm


def _assoc(M, N, rows, cols):
    """test_torch_associator's Sinkhorn cases: 2 problems, the first rows and
    columns valid."""
    def make(rng):
        rm, cm = _masks(rng, 2, M, N, rows, cols)
        return rng.normal(size=(2, M, N)).astype(F) * 3, rm, cm
    return make


def _empty(rows_valid: bool, cols_valid: bool):
    """The lane shape with every row (an empty store), every column (a frame
    without detections) or both masked, lane 0 of 4; the other lanes live."""
    def make(rng):
        S, M, N = 4, 64, 30
        rm, cm = _masks(rng, S, M, N, np.array([0 if not rows_valid else 48, 48, 20, 64]),
                        np.array([0 if not cols_valid else 26, 26, 30, 1]))
        return rng.normal(size=(S, M, N)).astype(F) * 3, rm, cm
    return make


CASES = {
    "lanes 16x64x30": _lane,
    "assoc 8x5": _assoc(8, 5, 8, 5),
    "assoc 16x30": _assoc(16, 30, 5, 7),
    "assoc 64x30": _assoc(64, 30, 3, 4),
    "empty store": _empty(False, True),
    "no detections": _empty(True, False),
    "both empty": _empty(False, False),
}


@pytest.fixture(scope="module")
def references():
    """Per (case, iters): the inputs, the plain version's output and JAX's."""
    import jax.numpy as jnp

    from odam_tpu.ops import sinkhorn as j_sink

    out = {}
    for n, (name, make) in enumerate(CASES.items()):
        scores, rm, cm = make(np.random.default_rng(n))
        for iters in ITERS:
            args = (scores, rm, cm)
            plain = t_sink.log_optimal_transport(
                torch.from_numpy(scores), torch.tensor(ALPHA), iters=iters,
                row_mask=torch.from_numpy(rm), col_mask=torch.from_numpy(cm)).numpy()
            jx = np.asarray(j_sink.log_optimal_transport(
                jnp.asarray(scores), jnp.asarray(ALPHA, jnp.float32), iters=iters,
                row_mask=jnp.asarray(rm), col_mask=jnp.asarray(cm)))
            out[name, iters] = (args, plain, jx)
    return out


def assert_same_transport(got: np.ndarray, want: np.ndarray) -> None:
    """Live entries within LIVE_ATOL, entries near -1e9 within MASKED_RTOL,
    and the -inf, +inf and NaN entries exactly where ``want`` has them."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for sign in (1, -1):
        np.testing.assert_array_equal(got == sign * np.inf, want == sign * np.inf)
    finite = np.isfinite(want)
    live = finite & (want > -1e8)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=LIVE_ATOL)
    np.testing.assert_allclose(got[finite & ~live], want[finite & ~live], rtol=MASKED_RTOL)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernel_equals_plain_and_jax(references, name, iters):
    (scores, rm, cm), plain, jx = references[name, iters]
    got = kernel_emulation(scores, ALPHA, iters, rm, cm)
    assert_same_transport(got, plain)
    assert_same_transport(got, jx)
    assert_same_transport(plain, jx)


def test_the_edge_cases_give_the_non_finite_entries_they_should(references):
    """What the exact -inf / NaN comparison above holds: an empty store makes
    the dustbin column -inf, no detections the dustbin row, both at once NaN
    everywhere after an iteration (-inf at 0 iterations: Z - inf)."""
    for iters in ITERS[1:]:
        _, store, _ = references["empty store", iters]
        assert np.isneginf(store[0, :, -1]).all() and np.isfinite(store[0, :, :-1]).all()
        _, dets, _ = references["no detections", iters]
        assert np.isneginf(dets[0, -1, :]).all() and np.isfinite(dets[0, :-1, :]).all()
        _, both, _ = references["both empty", iters]
        assert np.isnan(both[0]).all()
        for out in (store, dets, both):
            assert np.isfinite(out[1:]).all()              # the other lanes live
    assert np.isneginf(references["both empty", 0][1][0]).all()


def test_a_cpu_call_counts_one_plain_call_and_no_launch():
    scores, rm, cm = _lane(np.random.default_rng(0))
    kernels.zero_counts()
    with torch.no_grad():
        t_sink.log_optimal_transport(torch.from_numpy(scores), torch.tensor(ALPHA), iters=3,
                                     row_mask=torch.from_numpy(rm),
                                     col_mask=torch.from_numpy(cm))
    assert kernels.counts("LAUNCHES")["sinkhorn"] == 0
    assert kernels.counts("PLAIN_CALLS")["sinkhorn"] == 1
    counters = metrics.snapshot()["counters"]
    assert counters["sinkhorn"] == {
        "LAUNCHES": {"sinkhorn": 0}, "PLAIN_CALLS": {"sinkhorn": 1},
        "LAUNCHES_BY_DTYPE": {"sinkhorn": {"float32": 0}},
        "PLAIN_CALLS_BY_DTYPE": {"sinkhorn": {"float32": 1}}}
    assert counters["build"]["sinkhorn"] == kernels.SINKHORN.info
    kernels.zero_counts()
    assert kernels.counts("PLAIN_CALLS")["sinkhorn"] == 0


def test_a_call_that_needs_a_gradient_backpropagates_as_the_plain_version():
    """On CPU tensors a call whose scores and bin score require grad runs the
    plain version: the same log assignment and the same gradients, bit for
    bit, as a direct call of it."""
    scores, rm, cm = _assoc(16, 30, 5, 7)(np.random.default_rng(1))
    grads = []
    for fn in (t_sink.log_optimal_transport, t_sink.log_optimal_transport_plain):
        s = torch.from_numpy(scores).requires_grad_()
        a = torch.tensor(ALPHA, requires_grad=True)
        kernels.zero_counts()
        Z = fn(s, a, iters=20, row_mask=torch.from_numpy(rm), col_mask=torch.from_numpy(cm))
        (Z[:, :-1, :-1].exp() * torch.arange(30.0)).sum().backward()
        grads.append((Z.detach(), s.grad, a.grad, kernels.counts("PLAIN_CALLS")["sinkhorn"]))
    (Z, gs, ga, calls), (Z_ref, gs_ref, ga_ref, _) = grads
    assert calls == 1 and kernels.counts("LAUNCHES")["sinkhorn"] == 0
    assert torch.equal(Z, Z_ref) and torch.equal(gs, gs_ref) and torch.equal(ga, ga_ref)
    assert bool(gs.abs().sum() > 0) and bool(ga != 0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_the_associator_takes_the_plain_version_itself_without_kernels(monkeypatch, use_kernels):
    """With ``use_kernels`` the associator's transport goes through
    ``log_optimal_transport`` (the module attribute, which the benchmark's
    planted faults replace), one counted plain call on the CPU; without it
    (training) the associator calls the plain version directly, and the
    log assignment is the same."""
    cfg = t_assoc.AssociatorConfig(descriptor_dim=32, keypoint_encoder=(78, 32, 32),
                                   gnn_layers=("self", "cross"), self_gnn_layers=("self",),
                                   sinkhorn_iterations=20, use_kernels=use_kernels)
    model = t_assoc.build_associator(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    tracks = torch.from_numpy(rng.normal(size=(2, 6, 4, 79)).astype(F) * 0.5)
    dets = torch.from_numpy(rng.normal(size=(2, 5, 79)).astype(F) * 0.5)
    tm = torch.from_numpy(np.arange(6)[None] < np.array([[4], [6]]))
    dm = torch.from_numpy(np.arange(5)[None] < np.array([[5], [2]]))
    routed = []
    real = t_sink.log_optimal_transport
    monkeypatch.setattr(t_sink, "log_optimal_transport",
                        lambda *a, **k: routed.append(1) or real(*a, **k))
    kernels.zero_counts()
    with torch.no_grad():
        Z, scores = model.assignment(tracks, tm, dets, dm)
    assert len(routed) == kernels.counts("PLAIN_CALLS")["sinkhorn"] == int(use_kernels)
    assert kernels.counts("LAUNCHES")["sinkhorn"] == 0
    want = t_sink.log_optimal_transport_plain(scores, model.bin_score.detach(), 20, tm, dm)
    assert torch.equal(Z, want)


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.h100
@pytest.mark.parametrize("iters", ITERS)
def test_kernel_matches_the_plain_version_on_the_card(card, iters):
    """Every case of ``CASES`` on the card: one launch each, the plain
    version's output within float32 rounding and its -inf and NaN exactly."""
    for n, (name, make) in enumerate(CASES.items()):
        scores, rm, cm = (torch.from_numpy(a).to(card) for a in make(np.random.default_rng(n)))
        alpha = torch.tensor(ALPHA, device=card)
        launches = kernels.counts("LAUNCHES")["sinkhorn"]
        with torch.no_grad():
            got = t_sink.log_optimal_transport(scores, alpha, iters, rm, cm)
            want = t_sink.log_optimal_transport_plain(scores, alpha, iters, rm, cm)
        torch.cuda.synchronize()
        assert kernels.counts("LAUNCHES")["sinkhorn"] == launches + 1, name
        assert_same_transport(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.h100
def test_kernel_replayed_from_a_cuda_graph_equals_its_eager_launch(card):
    scores, rm, cm = (torch.from_numpy(a).to(card) for a in _lane(np.random.default_rng(5)))
    alpha = torch.tensor(ALPHA, device=card)
    with torch.no_grad():
        eager = t_sink.log_optimal_transport(scores, alpha, 100, rm, cm)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            t_sink.log_optimal_transport(scores, alpha, 100, rm, cm)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = t_sink.log_optimal_transport(scores, alpha, 100, rm, cm)
        captured.fill_(0.0)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.h100
def test_the_kernel_refuses_a_gradient_and_what_a_block_cannot_hold(card):
    scores, rm, cm = (torch.from_numpy(a).to(card) for a in _lane(np.random.default_rng(6)))
    alpha = torch.tensor(ALPHA, device=card, requires_grad=True)
    launches = kernels.counts("LAUNCHES")["sinkhorn"]
    with pytest.raises(RuntimeError, match="no backward"):
        t_sink.log_optimal_transport(scores, alpha, 3, rm, cm)
    with torch.no_grad():
        t_sink.log_optimal_transport(scores, alpha, 3, rm, cm)      # the same call, no grad
        with pytest.raises(ValueError, match=r"the Z \[2001, 129\] of a \[2000, 128\] "
                                             r"problem.*do not fit one block's shared memory"):
            t_sink.log_optimal_transport(torch.zeros(1, 2000, 128, device=card), alpha, 3)
    assert kernels.counts("LAUNCHES")["sinkhorn"] == launches + 1
