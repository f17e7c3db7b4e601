"""odam_torch's associator, Sinkhorn and assignment decodes against odam_tpu
(and scipy) on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from odam_torch.models import associator as t_assoc
from odam_torch.ops import lap as t_lap
from odam_torch.ops import sinkhorn as t_sink
from odam_tpu.models import associator as j_assoc
from odam_tpu.ops import lap as j_lap
from odam_tpu.ops import sinkhorn as j_sink

LOG_ASSIGNMENT_ATOL = 5e-4   # tests/test_aux.py:292-298


@pytest.mark.parametrize("m,n,n_valid_rows,n_valid_cols", [(8, 5, 8, 5), (16, 30, 5, 7),
                                                           (64, 30, 3, 4)])
def test_log_optimal_transport_matches(m, n, n_valid_rows, n_valid_cols):
    rng = np.random.default_rng(m * n)
    scores = rng.normal(size=(2, m, n)).astype(np.float32) * 3
    rm = np.zeros((2, m), bool)
    rm[:, :n_valid_rows] = True
    cm = np.zeros((2, n), bool)
    cm[:, :n_valid_cols] = True
    ref = j_sink.log_optimal_transport(jnp.asarray(scores), jnp.asarray(1.3), iters=50,
                                       row_mask=jnp.asarray(rm), col_mask=jnp.asarray(cm))
    out = t_sink.log_optimal_transport(torch.from_numpy(scores), torch.tensor(1.3), iters=50,
                                       row_mask=torch.from_numpy(rm),
                                       col_mask=torch.from_numpy(cm))
    ref, out = np.asarray(ref), out.numpy()
    live = ref > -1e8     # masked pairs sit near -1e9, compared by relative error
    np.testing.assert_allclose(out[live], ref[live], atol=LOG_ASSIGNMENT_ATOL)
    np.testing.assert_allclose(out[~live], ref[~live], rtol=1e-6)


def _assoc_inputs(seed, T, W, N, n_tracks, n_dets, fill):
    rng = np.random.default_rng(seed)
    tracks = np.full((1, T, W, 79), -1.0, np.float32)
    tracks[0, :n_tracks, :fill] = rng.normal(size=(n_tracks, fill, 79)) * 0.5
    tracks[0, :n_tracks, :fill, 0] = np.arange(fill)
    dets = np.full((1, N, 79), -1.0, np.float32)
    dets[0, :n_dets] = rng.normal(size=(n_dets, 79)) * 0.5
    dets[0, :n_dets, 0] = fill
    # make detection i a noisy copy of track i's last row, so matches are real
    k = min(n_tracks, n_dets)
    dets[0, :k, 1:] = tracks[0, :k, fill - 1, 1:] + rng.normal(size=(k, 78)) * 0.05
    tm = np.arange(T)[None] < n_tracks
    dm = np.arange(N)[None] < n_dets
    return tracks, tm, dets, dm


@pytest.mark.parametrize("decode", ["exact", "greedy"])
@pytest.mark.parametrize("seed,n_tracks,n_dets", [(0, 5, 4), (1, 8, 8), (2, 3, 7)])
def test_associator_matches(decode, seed, n_tracks, n_dets):
    """log_assignment within atol 5e-4 and matches exact, with padded track
    slots (masked) and padded detection rows (attended)."""
    cfg_kw = dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32),
                  gnn_layers=("self", "cross", "self", "cross"), self_gnn_layers=("self",),
                  sinkhorn_iterations=30, decode=decode)
    T, W, N = 8, 6, 10
    tracks, tm, dets, dm = _assoc_inputs(seed, T, W, N, n_tracks, n_dets, fill=4)
    jmodel = j_assoc.Associator(j_assoc.AssociatorConfig(**cfg_kw))
    params = jmodel.init(jax.random.key(seed), jnp.asarray(tracks), jnp.asarray(tm),
                         jnp.asarray(dets), jnp.asarray(dm))
    jo = jmodel.apply(params, jnp.asarray(tracks), jnp.asarray(tm), jnp.asarray(dets),
                      jnp.asarray(dm), 0.1)
    tmodel = t_assoc.build_associator(t_assoc.AssociatorConfig(**cfg_kw),
                                      flax_params=jax.tree.map(np.asarray, params),
                                      device="cpu")
    before = t_lap.PLAIN_CALLS["lap_solve"]
    with torch.no_grad():
        to = tmodel(torch.from_numpy(tracks), torch.from_numpy(tm), torch.from_numpy(dets),
                    torch.from_numpy(dm), 0.1)
    ref = np.asarray(jo.log_assignment)
    live = ref > -1e8
    np.testing.assert_allclose(to.log_assignment.numpy()[live], ref[live],
                               atol=LOG_ASSIGNMENT_ATOL)
    np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), atol=1e-4)
    np.testing.assert_array_equal(to.matches.numpy(), np.asarray(jo.matches))
    assert (to.matches.numpy() >= 0).sum() > 0
    # the exact decode solves the whole batch in one call
    assert t_lap.PLAIN_CALLS["lap_solve"] - before == (decode == "exact")


def _objective(score, track_for_det):
    return sum(score[t, d] for d, t in enumerate(track_for_det) if t >= 0)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("M,N", [(64, 30), (6, 9), (12, 12)])
def test_match_by_score_matches_jax_and_scipy(seed, M, N):
    """The host solver replays JAX's float32 steps, so matches are exact; the
    objective equals scipy's optimum, and any divergence from scipy is on a
    certified tie (equal total score)."""
    rng = np.random.default_rng(seed)
    score = rng.random((M, N)).astype(np.float32)
    rm = rng.random(M) < 0.7
    cm = rng.random(N) < 0.8
    threshold = 0.0
    ref = np.asarray(j_lap.match_by_score(jnp.asarray(score), threshold, jnp.asarray(rm),
                                          jnp.asarray(cm)))
    out = t_lap.match_by_score(torch.from_numpy(score), threshold, torch.from_numpy(rm),
                               torch.from_numpy(cm)).numpy()
    np.testing.assert_array_equal(out, ref)
    sub = score[np.ix_(rm, cm)]
    r, c = linear_sum_assignment(-sub)
    best = sub[r, c].sum()
    np.testing.assert_allclose(_objective(score, out), best, rtol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_greedy_peel_matches_jax(seed):
    rng = np.random.default_rng(seed)
    M, N = 16, 10
    score = rng.random((M, N)).astype(np.float32)
    score[3, 2] = score[4, 5] = score.max()       # an exact tie: the first flat index wins
    rm = rng.random(M) < 0.8
    cm = rng.random(N) < 0.9
    ref = np.asarray(j_lap.greedy_peel_match(jnp.asarray(score), 0.3, jnp.asarray(rm),
                                             jnp.asarray(cm)))
    out = t_lap.greedy_peel_match(torch.from_numpy(score), 0.3, torch.from_numpy(rm),
                                  torch.from_numpy(cm)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_exact_decode_on_sinkhorn_output_agrees_with_greedy_on_permutations():
    """On a near-permutation score matrix the two decodes agree (both are
    ported; the pipeline's default is the exact one)."""
    rng = np.random.default_rng(7)
    M, N = 10, 8
    perm = rng.permutation(M)[:N]
    score = rng.random((M, N)).astype(np.float32) * 0.05
    score[perm, np.arange(N)] = 0.95
    t = torch.from_numpy(score)
    np.testing.assert_array_equal(t_lap.match_by_score(t, 0.1).numpy(),
                                  t_lap.greedy_peel_match(t, 0.1).numpy())
