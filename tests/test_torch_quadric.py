"""odam_torch's dual-quadric module and the "exact" track re-projection
against odam_tpu on the CPU: the projected conic bbox and
``prepare_track_inputs(mode="exact")``.  Each test states its bar."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.mapping import quadric as t_quad
from odam_torch.runtime import processor as t_proc
from odam_torch.runtime import tracker as t_trk
from odam_tpu.mapping import quadric as j_quad
from odam_tpu.runtime import processor as j_proc
from odam_tpu.runtime import tracker as j_trk
from torch_threads import one_torch_thread  # noqa: F401

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _ellipsoids(rng, n):
    t = (rng.normal(size=(n, 3)) + [0, 0, 5]).astype(np.float32)
    yaw = rng.uniform(-3, 3, n).astype(np.float32)
    axes_sq = (rng.uniform(0.2, 1.2, (n, 3)) ** 2).astype(np.float32)
    return t, yaw, axes_sq


def _cameras(rng, n):
    P = []
    for _ in range(n):
        R = np.linalg.qr(rng.normal(size=(3, 3)) * 0.1 + np.eye(3))[0]
        R *= np.sign(np.diag(R))[None]
        P.append(K @ np.c_[R, rng.normal(size=3) * 0.3])
    return np.asarray(P, np.float32)


def test_quadric_bbox_matches():
    """quadric_matrix, project_quadric, conic_bbox_lines and quadric_bbox on
    12 ellipsoids under 5 cameras: the quadrics within 1e-5, the conics
    within 1e-5 of their largest entry (up to 5e6; float32 products summed
    in another order cancel in the small entries), and the boxes within atol
    1e-4 in normalized image coordinates, as the pipeline uses them (in
    pixels the square root of the discriminant's cancellation moves a box
    edge by up to 8e-4 px, 1.6e-6 relative)."""
    rng = np.random.default_rng(0)
    t, yaw, axes_sq = _ellipsoids(rng, 12)
    P = _cameras(rng, 5)
    tQ = t_quad.quadric_matrix(T(t), T(yaw), T(axes_sq))
    jQ = j_quad.quadric_matrix(jnp.asarray(t), jnp.asarray(yaw), jnp.asarray(axes_sq))
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), rtol=1e-5, atol=1e-5)
    tP, jP = T(P)[:, None], jnp.asarray(P)[:, None]
    jC = np.asarray(j_quad.project_quadric(jQ[None], jP))
    np.testing.assert_allclose(t_quad.project_quadric(tQ[None], tP).numpy(), jC,
                               atol=1e-5 * np.abs(jC).max())
    tb = t_quad.quadric_bbox(tQ[None], tP).numpy()
    jb = np.asarray(j_quad.quadric_bbox(jQ[None], jP))
    assert tb.shape == (5, 12, 4) and np.isfinite(tb).all()
    norm = np.array([640.0, 480.0, 640.0, 480.0], np.float32)
    np.testing.assert_allclose(tb / norm, jb / norm, atol=1e-4)
    # a degenerate conic (discriminant below zero) stays finite, as in JAX
    C = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]], np.float32)
    np.testing.assert_allclose(t_quad.conic_bbox_lines(T(C)).numpy(),
                               np.asarray(j_quad.conic_bbox_lines(jnp.asarray(C))))


@pytest.mark.parametrize("depth", [3.0, 8.0, 15.0])
def test_quadric_bbox_at_depth(depth):
    """quadric_bbox of 8 ellipsoids centred ``depth`` m in front of 4
    cameras (all in front of every camera) against JAX: within atol 1e-4 in
    normalized image coordinates, the bar of test_quadric_bbox_matches."""
    rng = np.random.default_rng(int(depth))
    t = (rng.normal(size=(8, 3)) * [1.0, 1.0, 0.3] + [0, 0, depth]).astype(np.float32)
    yaw = rng.uniform(-3, 3, 8).astype(np.float32)
    axes_sq = (rng.uniform(0.2, 1.2, (8, 3)) ** 2).astype(np.float32)
    P = _cameras(rng, 4)
    tQ = t_quad.quadric_matrix(T(t), T(yaw), T(axes_sq))
    jQ = j_quad.quadric_matrix(jnp.asarray(t), jnp.asarray(yaw), jnp.asarray(axes_sq))
    tb = t_quad.quadric_bbox(tQ[None], T(P)[:, None]).numpy()
    jb = np.asarray(j_quad.quadric_bbox(jQ[None], jnp.asarray(P)[:, None]))
    assert tb.shape == (4, 8, 4) and np.isfinite(tb).all()
    norm = np.array([640.0, 480.0, 640.0, 480.0], np.float32)
    np.testing.assert_allclose(tb / norm, jb / norm, atol=1e-4)


def test_conic_bbox_lines_random_conics():
    """conic_bbox_lines on 64 random symmetric conics, about half of whose
    discriminants are below zero (clipped to zero in both packages): finite
    and within rtol 1e-5 + 1e-5 of the largest line of JAX's."""
    rng = np.random.default_rng(5)
    C = rng.normal(size=(64, 3, 3)).astype(np.float32)
    C = C + np.swapaxes(C, -1, -2)
    C[:, 2, 2] = rng.choice([-1.0, 1.0], 64) * rng.uniform(0.5, 2.0, 64)
    tl = t_quad.conic_bbox_lines(T(C)).numpy()
    jl = np.asarray(j_quad.conic_bbox_lines(jnp.asarray(C)))
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5 * np.abs(jl).max())


def _exact_store():
    """tests/test_runtime.py's exact-mode store: two tracks seen from a
    camera 4 m away."""
    rows = np.full((2, 82), -1.0, np.float32)
    for i, (c, dims, azi) in enumerate([([0.3, 0.2, 1.0], [0.8, 0.5, 0.9], 0.4),
                                        ([-0.5, -0.2, 0.8], [0.4, 0.7, 0.5], -0.9)]):
        rows[i, 0], rows[i, 1], rows[i, 6:9], rows[i, 9:12] = 3, 5, dims, c
        rows[i, 12], rows[i, 13] = azi, 0.9
    slots, valid = np.array([0, 1], np.int32), np.array([True, True])
    js = j_trk.append_rows(j_trk.init_store(max_tracks=2, window=4), jnp.asarray(rows),
                           jnp.asarray(slots), jnp.asarray(valid))
    ts = t_trk.append_rows(t_trk.init_store(2, 4, "cpu"), T(rows), T(slots), T(valid))
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0, -4.0, 0.9]
    T_wc[:3, :3] = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    return ts, js, T_wc


def test_prepare_track_inputs_exact_matches():
    """mode="exact" at tests/test_runtime.py's setting, and on a fuller store
    of 8 tracks from another pose: against JAX's within atol 1e-5
    (normalized coordinates; no sampling, so nothing rounds to another grid
    angle), and within 0.05 of the sampled mode's dense (20000-point)
    bbox, which contains it (the epsilon-0.9 surface bulges outward)."""
    ts, js, T_wc = _exact_store()
    j_args = (js, jnp.asarray(T_wc), jnp.asarray(K), jnp.asarray(640.0), jnp.asarray(480.0))
    exact = t_proc.prepare_track_inputs(ts, T(T_wc), T(K), 640.0, 480.0, mode="exact").numpy()
    np.testing.assert_allclose(exact, np.asarray(j_proc.prepare_track_inputs(*j_args,
                                                                              mode="exact")),
                               atol=1e-5)
    dense = t_proc.prepare_track_inputs(ts, T(T_wc), T(K), 640.0, 480.0, n_samples=20000).numpy()
    np.testing.assert_allclose(exact[:2, 0, 2:6], dense[:2, 0, 2:6], atol=0.05)
    assert (dense[:2, 0, 2:4] <= exact[:2, 0, 2:4] + 1e-3).all()
    assert (dense[:2, 0, 4:6] >= exact[:2, 0, 4:6] - 1e-3).all()
    np.testing.assert_allclose(exact[..., 6:], dense[..., 6:], atol=1e-6)
    with pytest.raises(ValueError, match="track_bbox_mode"):
        t_proc.prepare_track_inputs(ts, T(T_wc), T(K), 640.0, 480.0, mode="dense")

    rng = np.random.default_rng(4)
    ts, js = t_trk.init_store(8, 5, "cpu"), j_trk.init_store(8, 5)
    for frame in range(6):
        rows = rng.normal(size=(6, 82)).astype(np.float32)
        rows[:, 0] = frame
        rows[:, 6:9] = rng.uniform(0.2, 1.5, size=(6, 3))
        rows[:, 9:12] = rng.normal(size=(6, 3)) + [0, 0, 3]
        slots = rng.permutation(8)[:6].astype(np.int32)
        valid = rng.random(6) < 0.7
        ts = t_trk.append_rows(ts, T(rows), T(slots), T(valid))
        js = j_trk.append_rows(js, jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(valid))
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [0.3, -0.2, -0.5]
    out = t_proc.prepare_track_inputs(ts, T(T_wc), T(K), 640.0, 480.0, mode="exact").numpy()
    ref = j_proc.prepare_track_inputs(js, jnp.asarray(T_wc), jnp.asarray(K), jnp.asarray(640.0),
                                      jnp.asarray(480.0), mode="exact")
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
