"""odam_torch's LM mapping solver against odam_tpu's on the CPU.

Step by step: JAX's LM iteration is written out below with JAX's own
functions (the body of its scan), its trajectory is checked against JAX's
``optimize_superquadrics_lm``, and from JAX's own (x, lambda) at every
iteration the port's ``LMSolve.step`` must give JAX's next x within
STEP_ATOL and the same lambda.  End to end: the envelope and the fallback
routing exact, the final boxes against JAX's by oriented-3D IoU, and the
cases of ``tests/test_lm_solver.py`` (a masked and a frozen object, cube
mode, the near-planar fallback).  Each test states its bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.mapping import lm_solver as t_lm
from odam_torch.mapping import optimizer as t_opt
from odam_torch.mapping import superquadric as t_sq
from odam_torch.runtime import processor as t_proc
from odam_torch.utils.host_boxes import robust_box3d_iou
from odam_tpu.mapping import lm_solver as j_lm
from odam_tpu.mapping import superquadric as j_sq
from odam_tpu.runtime import processor as j_proc
from test_lm_solver import _case, _ring, _views
from test_torch_mapping import _synthetic_tracks, solve_scene
from torch_threads import one_torch_thread  # noqa: F401

S, ITERS = 200, 25
# Per step: the port's x against JAX's from the same (x, lambda).  The soft
# extremes average the same surface samples, which the port places up to
# 8e-6 m from JAX's (float32 CDFs summed in another order); a Gauss-Newton
# step divides the residual by a J^T J whose smallest eigenvalues are
# damped by lambda, so a residual difference of a few 1e-5 px moves x by up
# to a few 1e-5.  The bar is 1e-3, a hundredth of a typical step.  The two
# shape logits are compared as the epsilons they give (sigmoid-squashed):
# LM drives some of them into the sigmoid's saturation, to -700 or -1800,
# where the logit itself is rounding noise (relative 1e-5) and epsilon is
# 0.2 in both packages.
STEP_ATOL = 1e-3
# The written-out JAX step against JAX's own scan: XLA fuses a one-step jit
# differently from the scan body, so they round differently, and 25 LM
# iterations grow that to 1.5e-3 at most (measured, quadric scene); a
# transcription error would show as a whole step, O(1e-2) and more.
JAX_SELF_ATOL = 5e-3
# An LM step is kept when it lowers the object's squared residual.  Near
# convergence a step changes it by less than rounding, and the decision can
# go either way in either package; where JAX's |cost_new - cost| / cost is
# below this, the port may decide otherwise (and its lambda differ by 8x).
TIE_RTOL = 1e-4


def _pose_and_eps(x):
    """[O, 9] packed params -> ([O, 7] pose and scales, [O, 2] epsilons)."""
    x = np.asarray(x, np.float64)
    return x[:, :7], 1.4 / (1.0 + np.exp(-np.clip(x[:, 7:], -500, 500))) + 0.2


def T(a):
    return torch.from_numpy(np.array(a))


def _jax_lm_trajectory(init, boxes, box_mask, view_mask, P_cw, om, invcov, *, n_iters,
                       n_samples, rep, use_prior):
    """JAX's LM set-up and iteration, written out with odam_tpu's functions
    (odam_tpu/mapping/lm_solver.py, the body of optimize_superquadrics_lm):
    [(x, lam, candidate x, |cost_new - cost| / cost)] before each iteration
    and after each (the first entry's last two are None)."""
    O, V, _ = boxes.shape
    params = j_sq.init_params(*map(jnp.asarray, init), rep)
    boxes, box_mask, view_mask, P_cw = map(jnp.asarray, (boxes, box_mask, view_mask, P_cw))
    om = jnp.asarray(om)
    invcov = jnp.zeros((O, 3, 3)) if invcov is None else jnp.asarray(invcov)
    chol = (jnp.linalg.cholesky(j_lm.PRIOR_WEIGHT * invcov + 1e-8 * jnp.eye(3)) if use_prior
            else jnp.zeros((O, 3, 3)))
    active = box_mask * view_mask[..., None]
    n_valid = jnp.maximum(jnp.sum(view_mask, axis=-1), 1.0)
    res_scale = 1.0 / jnp.sqrt(n_valid)
    diag = jnp.sqrt((boxes[..., 2] - boxes[..., 0]) ** 2 + (boxes[..., 3] - boxes[..., 1]) ** 2)
    diag = jnp.where(jnp.isnan(diag), 0.0, diag) * view_mask
    anchor_w = 0.1 * jnp.sum(diag, axis=-1) / n_valid
    x0 = j_lm._pack(params)
    t_init, s_init = x0[:, 0:3], params.scales
    free = jnp.concatenate([jnp.ones(7), jnp.full(2, 1.0 if rep == "super_quadric" else 0.0)])

    def residuals(x_o, P_o, b_o, a_o, rs_o, c_o, si_o, aw_o, ti_o, temp):
        p = j_sq.SQParams(translate=x_o[0:3][None], angle=x_o[3][None],
                          scales=x_o[4:7][None], shapes=x_o[7:9][None])
        r_edge = (j_lm._soft_extremes(p, P_o[None], n_samples, temp)[0] - b_o) * a_o * rs_o
        r_edge = jnp.where(jnp.isnan(r_edge), 0.0, r_edge)
        return jnp.concatenate([r_edge.reshape(V * 4), c_o @ (x_o[4:7] - si_o),
                                aw_o * (x_o[0:3] - ti_o)])

    @jax.jit
    def step(x, lam, it):
        frac = it / max(n_iters - 1, 1)
        temp = jnp.exp(jnp.log(2.0) + (jnp.log(50.0) - jnp.log(2.0)) * frac)

        def per_obj(x_o, P_o, b_o, a_o, rs_o, c_o, si_o, aw_o, ti_o, lam_o, on):
            r = residuals(x_o, P_o, b_o, a_o, rs_o, c_o, si_o, aw_o, ti_o, temp)
            J = jax.jacfwd(residuals)(x_o, P_o, b_o, a_o, rs_o, c_o, si_o, aw_o, ti_o,
                                      temp) * free[None, :]
            H = J.T @ J
            dx = jnp.linalg.solve(H + lam_o * jnp.eye(9) * (jnp.diag(H) + 1e-6), J.T @ r) * free
            r_new = residuals(x_o - dx, P_o, b_o, a_o, rs_o, c_o, si_o, aw_o, ti_o, temp)
            cost, cost_new = jnp.sum(r ** 2), jnp.sum(r_new ** 2)
            better = cost_new < cost
            return (jnp.where(better & on, x_o - dx, x_o),
                    jnp.clip(jnp.where(better, lam_o * 0.5, lam_o * 4.0), 1e-6, 1e4),
                    x_o - dx, jnp.abs(cost_new - cost) / jnp.maximum(cost, 1e-30))

        return jax.vmap(per_obj)(x, P_cw, boxes, active, res_scale, chol, s_init,
                                 anchor_w * jnp.exp(-4.0 * frac), t_init, lam, om)

    x, lam = x0, jnp.full((O,), 1e-2)
    traj = [(np.asarray(x), np.asarray(lam), None, None)]
    for it in range(n_iters):
        x, lam, cand, margin = step(x, lam, it)
        traj.append((np.asarray(x), np.asarray(lam), np.asarray(cand), np.asarray(margin)))
    return traj


def _single_object_case():
    """tests/test_lm_solver.py's convergence case: one object, 12 views."""
    center, dims, angle = np.array([0.1, -0.2, 0.8]), np.array([0.9, 0.6, 1.1]), 0.4
    Ps, boxes = _views(center, dims, angle)
    V = len(Ps)
    init = [(center + [0.35, -0.25, 0.2])[None].astype(np.float32),
            np.array([angle], np.float32), (dims * 1.4)[None].astype(np.float32)]
    inputs = (boxes[None], np.ones((1, V, 4), np.float32), np.ones((1, V), np.float32),
              Ps[None], np.ones(1, bool), None)
    return init, inputs


def _solve_inputs(case):
    if case == "single":
        return _single_object_case()
    init, inputs = solve_scene()
    return init, inputs


@pytest.mark.parametrize("case,rep,use_prior", [("single", "super_quadric", False),
                                                ("scene", "super_quadric", True),
                                                ("scene", "cube", False),
                                                ("scene", "quadric", True)])
def test_lm_step_matches_jax(case, rep, use_prior):
    """Teacher-forced over 25 iterations: from JAX's (x, lambda) before each,
    the port's step gives JAX's next x within STEP_ATOL and JAX's next
    lambda exactly, except on an accept decision that is a tie within
    TIE_RTOL, where it may take the other branch.  The written-out JAX step is itself held to JAX's
    optimize_superquadrics_lm (final pose and epsilons within
    JAX_SELF_ATOL).  ``scene`` is the Adam tests' six objects: partly
    masked edges, half the views of one object empty, a frozen object and a
    view with part of an object behind the camera."""
    init, inputs = _solve_inputs(case)
    boxes, box_mask, view_mask, P_cw, om, invcov = inputs
    kw = dict(n_iters=ITERS, n_samples=S, rep=rep, use_prior=use_prior)
    traj = _jax_lm_trajectory(init, *inputs, **kw)
    jres = j_lm.optimize_superquadrics_lm(
        j_sq.init_params(*map(jnp.asarray, init), rep), *map(jnp.asarray, inputs[:5]),
        None if invcov is None else jnp.asarray(invcov), n_iters=ITERS, n_samples=S,
        representation=rep, use_prior=use_prior)
    for a, b in zip(_pose_and_eps(traj[-1][0]), _pose_and_eps(j_lm._pack(jres.params))):
        np.testing.assert_allclose(a, b, atol=JAX_SELF_ATOL)

    solve = t_lm.LMSolve(t_sq.init_params(*map(T, init), rep), *map(T, (boxes, box_mask,
                                                                        view_mask, P_cw)),
                         None if invcov is None else T(invcov), n_iters=ITERS, n_samples=S,
                         representation=rep, use_prior=use_prior)
    on = T(om).bool()
    worst, ties = 0.0, 0
    for it in range(ITERS):
        (x, lam, _, _), (x_next, lam_next, cand, margin) = traj[it], traj[it + 1]
        tx, tlam, _ = solve.step(T(x), T(lam), it, on)
        tx, tlam = tx.numpy(), tlam.numpy()
        for o in range(len(lam)):
            if margin[o] < TIE_RTOL and tlam[o] != lam_next[o]:
                # the accept decision flipped on a rounding-level tie: the
                # port kept what JAX took, or took what JAX kept
                ties += 1
                other = cand[o] if np.array_equal(x_next[o], x[o]) else x[o]
                want = other if om[o] else x[o]
            else:
                want = x_next[o]
                assert tlam[o] == lam_next[o], (it, o, tlam[o], lam_next[o], margin[o])
            for a, b in zip(_pose_and_eps(tx[o:o + 1]), _pose_and_eps(want[None])):
                np.testing.assert_allclose(a, b, atol=STEP_ATOL, err_msg=f"iteration {it}")
                worst = max(worst, float(np.abs(a - b).max()))
    print(f"\n{case} {rep} prior={use_prior}: per step max |x - x_jax| {worst:.1e}, "
          f"{ties} accept decisions flipped on ties")


def _both_auto(init, inputs, **kw):
    boxes, box_mask, view_mask, P_cw, om, invcov = inputs
    jinv = None if invcov is None else jnp.asarray(invcov)
    tinv = None if invcov is None else T(invcov)
    jinit = j_sq.init_params(*map(jnp.asarray, init))
    jres = j_lm.optimize_superquadrics_auto(jinit, *map(jnp.asarray, inputs[:5]), jinv, **kw)
    tres = t_lm.optimize_superquadrics_auto(t_sq.init_params(*map(T, init)),
                                            *map(T, inputs[:5]), tinv, **kw)
    return jinit, jres, tres


def _jax_fallback(jinit, jres_lm, inputs, n_samples, accept=j_lm.ACCEPT_RESID_MAX):
    """JAX's routing, from its own functions and its LM result."""
    boxes, box_mask, view_mask, P_cw, om, _ = map(
        lambda a: None if a is None else jnp.asarray(a), inputs)
    ok = j_lm.lm_envelope_ok(jinit, box_mask, view_mask)
    resid = j_lm.normalized_fit_residual(jres_lm.params, boxes, box_mask, view_mask, P_cw,
                                         n_samples=n_samples)
    return np.asarray((om & ~ok) | (om & ok & (resid > accept)))


def test_envelope_and_fallback_routing_exact():
    """lm_envelope_ok exact on the JAX tests' cases and on random inputs;
    normalized_fit_residual within rtol 1e-4 of JAX's at the same params
    (the surface samples differ by up to 8e-6 m); the auto path's fallback
    mask equal to JAX's routing on a scene where some objects fall back
    (the six-object scene with object 4 near-planar and object 5's edges
    mostly masked)."""
    rng = np.random.default_rng(0)
    dims = np.concatenate([[[1.5, 1.4, 0.08], [1, 1, 1]], rng.uniform(0.05, 1.5, (30, 3))])
    masks = (rng.random((32, 6, 4)) < rng.uniform(0.2, 1.0, (32, 1, 1))).astype(np.float32)
    masks[1] = 0.0
    masks[1, :, 0] = 1.0
    views = (rng.random((32, 6)) < 0.9).astype(np.float32)
    args = (np.zeros((32, 3), np.float32), np.zeros(32, np.float32), dims.astype(np.float32))
    j_ok = j_lm.lm_envelope_ok(j_sq.init_params(*map(jnp.asarray, args)), jnp.asarray(masks),
                               jnp.asarray(views))
    t_ok = t_lm.lm_envelope_ok(t_sq.init_params(*map(T, args)), T(masks), T(views))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert 0 < int(t_ok.sum()) < 32

    init, inputs = solve_scene()
    init[2][4] = [1.4, 1.2, 0.1]                      # near-planar: out of the envelope
    box_mask = inputs[1].copy()
    box_mask[5, :, 1:] = 0.0                          # one edge of four: out of it
    inputs = (inputs[0], box_mask, *inputs[2:])
    p = t_sq.init_params(*map(T, init))
    jp = j_sq.init_params(*map(jnp.asarray, init))
    np.testing.assert_allclose(
        t_lm.normalized_fit_residual(p, *map(T, inputs[:4]), n_samples=S).numpy(),
        np.asarray(j_lm.normalized_fit_residual(jp, *map(jnp.asarray, inputs[:4]),
                                                n_samples=S)), rtol=1e-4)
    kw = dict(n_iters=10, n_samples=S, adam_iters=20, adam_samples=S)
    for accept in (j_lm.ACCEPT_RESID_MAX, 0.05):
        jinit, jres, tres = _both_auto(init, inputs, accept_resid=accept, **kw)
        ok = np.asarray(j_lm.lm_envelope_ok(jinit, jnp.asarray(box_mask),
                                            jnp.asarray(inputs[2])))
        jlm = j_lm.optimize_superquadrics_lm(
            jinit, *map(jnp.asarray, inputs[:4]), jnp.asarray(inputs[4] & ok),
            jnp.asarray(inputs[5]), n_iters=10, n_samples=S)
        want = _jax_fallback(jinit, jlm, inputs, S, accept)
        np.testing.assert_array_equal(tres.fallback.numpy(), want)
        assert want[4] and want[5] and not want[2]    # object 2 is frozen


def test_lm_final_boxes_match_jax():
    """Whole solves (25 iterations) of the single-object case and the
    six-object scene, each package on its own trajectory: the final boxes of
    every optimized object at oriented-3D IoU >= 0.98 with JAX's, the
    frozen object's box (the detector average) within 1e-6, and the loss
    log within rtol 1e-3.  LM's soft extremes make the loss smooth, so
    unlike the Adam solve the trajectories do not part."""
    for case in ("single", "scene"):
        init, inputs = _solve_inputs(case)
        jinv = None if inputs[5] is None else jnp.asarray(inputs[5])
        jres = j_lm.optimize_superquadrics_lm(
            j_sq.init_params(*map(jnp.asarray, init)), *map(jnp.asarray, inputs[:5]), jinv,
            n_iters=ITERS, n_samples=S)
        tres = t_lm.optimize_superquadrics_lm(
            t_sq.init_params(*map(T, init)), *map(T, inputs[:5]),
            None if inputs[5] is None else T(inputs[5]), n_iters=ITERS, n_samples=S)
        np.testing.assert_allclose(tres.loss_log.numpy(), np.asarray(jres.loss_log), rtol=1e-3)
        ious = []
        for o, on in enumerate(inputs[4]):
            a, b = tres.corners[o].numpy(), np.asarray(jres.corners[o])
            if on:
                ious.append(robust_box3d_iou(a, b))
            else:
                np.testing.assert_allclose(a, b, atol=1e-6)
        print(f"\n{case}: LM boxes port vs JAX min IoU {min(ious):.5f}")
        assert min(ious) >= 0.98, ious


def test_lm_masked_object_and_cube_mode():
    """tests/test_lm_solver.py's freeze and cube cases: a frozen object's
    params and box unchanged (atol 1e-6 / 1e-5), the cube's shape logits
    pinned; and each against JAX's (params within 1e-4 + 1e-5 relative: the
    frozen case's free object drifts to a translation of 21 m)."""
    init = (np.zeros((2, 3), np.float32), np.zeros(2, np.float32), np.ones((2, 3), np.float32))
    V = 4
    P = np.broadcast_to(np.concatenate([np.eye(3), np.ones((3, 1))], 1),
                        (2, V, 3, 4)).astype(np.float32)
    inputs = (np.full((2, V, 4), 100.0, np.float32), np.ones((2, V, 4), np.float32),
              np.ones((2, V), np.float32), P, np.array([True, False]))
    res = t_lm.optimize_superquadrics_lm(t_sq.init_params(*map(T, init)), *map(T, inputs),
                                         None, n_iters=5, n_samples=64, use_prior=False)
    jres = j_lm.optimize_superquadrics_lm(j_sq.init_params(*map(jnp.asarray, init)),
                                          *map(jnp.asarray, inputs), None, n_iters=5,
                                          n_samples=64, use_prior=False)
    assert np.isfinite(res.corners.numpy()).all()
    np.testing.assert_allclose(res.params.translate[1].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(res.corners[1].numpy(), res.corners_detector[1].numpy(),
                               atol=1e-5)
    for a, b in zip(res.params, jres.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-5)

    Ps, boxes = _views(np.array([0.0, 0.0, 0.5]), np.ones(3), 0.0, n_views=6)
    cube = (np.zeros((1, 3), np.float32), np.zeros(1, np.float32), np.ones((1, 3), np.float32))
    cin = (boxes[None], np.ones((1, 6, 4), np.float32), np.ones((1, 6), np.float32), Ps[None],
           np.ones(1, bool))
    res = t_lm.optimize_superquadrics_lm(t_sq.init_params(*map(T, cube), "cube"), *map(T, cin),
                                         None, n_iters=5, n_samples=64, representation="cube",
                                         use_prior=False)
    jres = j_lm.optimize_superquadrics_lm(j_sq.init_params(*map(jnp.asarray, cube), "cube"),
                                          *map(jnp.asarray, cin), None, n_iters=5,
                                          n_samples=64, representation="cube", use_prior=False)
    np.testing.assert_allclose(res.params.shapes[0].numpy(), t_sq.CUBE_SHAPE_LOGIT, atol=1e-4)
    for a, b in zip(res.params, jres.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_auto_fallback_recovers_near_planar():
    """tests/test_lm_solver.py's near-planar case: the auto path routes the
    object to Adam in both packages, the port's auto box equals the port's
    own Adam solve (atol 1e-6), and JAX's within oriented-3D IoU 0.85 (the
    Adam solve's own spread, tests/test_torch_mapping.py)."""
    c, dims = np.array([0.1, -0.2, 0.8]), np.array([1.5, 1.4, 0.08])
    Ps, boxes, mask, gt = _case(c, dims, 0.3, _ring(c, 3.0, 1.2, 10))
    V = len(Ps)
    init = [(c + [0.3, -0.2, 0.1])[None].astype(np.float32), np.array([0.45], np.float32),
            (dims * 1.35)[None].astype(np.float32)]
    inputs = (boxes[None], mask[None], np.ones((1, V), np.float32), Ps[None], np.ones(1, bool),
              None)
    kw = dict(n_iters=25, n_samples=256, adam_iters=150, adam_samples=256, use_prior=False)
    jinit, jres, tres = _both_auto(init, inputs, **kw)
    assert tres.fallback.numpy().tolist() == [True]
    adam = t_opt.optimize_superquadrics(t_sq.init_params(*map(T, init)), *map(T, inputs[:5]),
                                        None, n_iters=150, n_samples=256, use_prior=False)
    np.testing.assert_allclose(tres.corners.numpy(), adam.corners.numpy(), atol=1e-6)
    assert robust_box3d_iou(tres.corners[0].numpy(), np.asarray(jres.corners[0])) >= 0.85
    assert t_lm.HOST_READS["fallback_any"] > 0


def test_optim_process_lm_matches():
    """optim_process with ``optim_solver="lm"`` on the Adam test's three
    objects (O 8, V 32, S 200, 40 LM iterations): the same tracks in the same
    order, no object left to Adam, every box at oriented-3D IoU >= 0.98
    with JAX's and within IoU 0.6 of its ground truth."""
    from test_torch_mapping import gt_corners

    cfg = dict(max_objs=8, max_views=32, optim_samples=S, optim_solver="lm")
    tracks, seq, objects = _synthetic_tracks(np.random.default_rng(6))
    tracks = [tracks[0], tracks[1], tracks[2]]
    jpipe = j_proc.OdamPipeline.__new__(j_proc.OdamPipeline)
    jpipe.cfg, jpipe.sequence = j_proc.PipelineConfig(**cfg), dict(seq)
    tpipe = t_proc.OdamPipeline.__new__(t_proc.OdamPipeline)
    tpipe.cfg, tpipe.device = t_proc.PipelineConfig(**cfg), torch.device("cpu")
    tpipe.sequence = dict(seq)
    jo, to = jpipe.optim_process(tracks), tpipe.optim_process(tracks)
    assert to["n_fallback"] == 0 and len(to["tracks"]) == len(jo["tracks"]) == 3
    for k in range(3):
        np.testing.assert_array_equal(to["tracks"][k], jo["tracks"][k])
        assert robust_box3d_iou(to["bboxes_qc"][k], jo["bboxes_qc"][k]) >= 0.98
        c, d, y, _ = objects[k]
        assert robust_box3d_iou(to["bboxes_qc"][k], gt_corners(d, y, c)) > 0.6
    assert to["loss_log"].shape == (40,)
