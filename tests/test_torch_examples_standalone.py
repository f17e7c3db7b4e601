"""The three standalone examples of ``odam_torch.examples`` against the JAX
package's ``examples/`` on the CPU.

- ``fit_superquadric.main`` at 20 iterations against JAX's (one fit in
  each package, its outputs taken from ``main``'s call of ``fit``): the
  loss log within rtol 1e-4 (the port's surface samples differ from JAX's
  by up to 8e-6 m, ``test_torch_mapping.py``); the parameters after the
  first iteration within 1e-6 but for the elements whose JAX gradient at
  the init is at rounding level (below 1e-6: ``size_sqrt[2]``, 4.9e-8 in
  JAX and -3.2e-8 here, a sum of terms that cancel by the sampler's
  symmetry; the next smallest is 3.5e-5), which Adam, normalising each
  element, steps by up to lr either way; after the 20 iterations each
  element within its FINAL_ATOL, the split of that first step carried
  through the coupled loss (``pos`` 1e-5, ``shape_raw`` and
  ``size_sqrt[0]`` 2e-3, the two elements of smallest gradient 2 x 20 x
  lr); the ``.obj`` meshes and the PNG written;
- ``synthetic_mapping``: the scene and its constraints against the script's
  own lines run on ``odam_tpu`` (boxes within 1e-4 px: the float32 corners
  may differ by an ulp; masks, classes and counts exact), then the Adam
  solve at 20 iterations: ``loss_log[0]`` within rtol 1e-5 and the first 20
  iterations within rtol 1e-3 (``test_torch_mapping.py``'s bars), each slot's
  IoU with the ground truth within 1e-3, and the merge's track count equal;
- ``train_associator_synthetic``: the scenes, the dataset's first batch, and
  ``evaluate_scene`` with JAX's seeded init converted: precision, recall
  and F1 equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.examples import fit_superquadric as t_fit
from odam_torch.examples import synthetic_mapping as t_map
from odam_torch.examples import train_associator_synthetic as t_tas
from odam_torch.scripts.train_associator import BATCH_KEYS
from odam_tpu.data import datasets as j_datasets
from odam_tpu.eval import association as j_association
from odam_tpu.mapping import constraints as j_constraints
from odam_tpu.mapping import merge as j_merge
from odam_tpu.mapping import optimizer as j_opt
from odam_tpu.mapping import prior as j_prior
from odam_tpu.mapping import superquadric as j_sq
from odam_tpu.models import associator as j_assoc
from odam_tpu.utils import geometry as j_geo
from odam_tpu.utils import host_boxes as j_hb

from jax_examples import jax_module
from torch_threads import one_torch_thread  # noqa: F401

ITERS = 20


LR = 5e-3                   # fit's default, main's too
ROUNDING_GRAD = 1e-6        # a JAX gradient element at the init below this is rounding
# after ITERS iterations (measured: pos 1.1e-6, shape_raw 4.4e-4, size_sqrt
# 4.6e-4 / 5.8e-2 / 1.2e-2): size_sqrt[1] and [2] have the two smallest
# gradients at the init (3.5e-5 and rounding), where Adam's normalised step
# of up to lr either way is what the first step's split carries, so they
# are bound by 2 x ITERS x lr
FINAL_ATOL = {"pos": np.full(3, 1e-5), "shape_raw": np.full(2, 2e-3),
              "size_sqrt": np.array([2e-3, 2 * ITERS * LR, 2 * ITERS * LR])}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Both packages' ``main`` (summary and artifacts) at ITERS iterations,
    with what its call of ``fit`` returned (loss log and parameters)."""
    tmp = tmp_path_factory.mktemp("fit")
    j_fit = jax_module("fit_superquadric.py")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("jax", j_fit), ("torch", t_fit)):
            fit = mod.fit

            def spy(*args, fit=fit, name=name, **kwargs):
                out[name] = fit(*args, **kwargs)
                return out[name]

            mp.setattr(mod, "fit", spy)
        out["jax_main"] = j_fit.main(str(tmp / "jax"), n_iters=ITERS, seed=0, verbose=False)
        out["torch_main"] = t_fit.main(str(tmp / "torch"), n_iters=ITERS, seed=0,
                                       verbose=False, device="cpu")
    return out


def _jax_grad_at_init():
    """JAX's gradient of the demo's loss at the fit's init (seed 0)."""
    from odam_tpu.ops import surface as j_surface

    j_fit = jax_module("fit_superquadric.py")
    gt_pts = j_fit.sample_sq(*map(jnp.asarray, t_fit.ground_truth(0)))

    def loss_fn(p):
        pts = j_fit.sample_sq(p["pos"], p["size_sqrt"] ** 2, j_surface.squash_shape(p["shape_raw"]))
        return jnp.mean(jnp.abs(pts - gt_pts))

    init = {"size_sqrt": jnp.ones(3), "shape_raw": jnp.zeros(2), "pos": jnp.zeros(3)}
    return {k: np.asarray(v) for k, v in jax.grad(loss_fn)(init).items()}


def test_fit_loss_log_equals_jax(fits):
    _, _, jl, _, jidx = fits["jax"]
    _, tck, tl, _, tidx = fits["torch"]
    np.testing.assert_array_equal(tidx, jidx)
    assert len(tck) == t_fit.CHECKPOINTS
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)


def test_fit_parameters_within_f32_bars(fits):
    grad = _jax_grad_at_init()
    rounding = {k: np.abs(g) < ROUNDING_GRAD for k, g in grad.items()}
    # the one element whose gradient at the init is rounding: size_sqrt[2]
    assert {k: np.flatnonzero(m).tolist() for k, m in rounding.items() if m.any()} == {
        "size_sqrt": [2]}, grad
    # after the first iteration (checkpoint 0)
    j1, t1 = fits["jax"][1][0], fits["torch"][1][0]
    for k in t_fit.PARAMS:
        d = np.abs(t1[k] - np.asarray(j1[k]))
        assert (d[~rounding[k]] <= 1e-6).all(), (k, d)
        assert (d[rounding[k]] <= 2 * LR).all(), (k, d)
    # after ITERS iterations
    jp, tp = fits["jax"][3], fits["torch"][3]
    for k in t_fit.PARAMS:
        d = np.abs(tp[k] - np.asarray(jp[k]))
        assert (d <= FINAL_ATOL[k]).all(), (k, d)


def test_fit_main_summary_and_artifacts(fits):
    jr, tr = fits["jax_main"], fits["torch_main"]
    for key in ("loss_first", "loss_final"):
        np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, err_msg=key)
    assert tr["loss_final"] < tr["loss_first"]
    for key in ("gt", "fitted", "strip"):
        with open(tr["paths"][key], "rb") as f:
            assert len(f.read()) > 0
    with open(tr["paths"]["fitted"]) as f:
        assert f.read(2) == "v "


def _jax_scene():
    """``examples/synthetic_mapping.py``'s scene, its lines on ``odam_tpu``."""
    objects = [(c, d, y, k) for c, d, y, k in t_map.OBJECTS]
    P_cws, tracks = [], [[] for _ in range(3)]
    rngn = np.random.default_rng(0)
    for f in range(60):
        phi = 0.8 * np.pi * f / 60
        cam = np.array([2.8 * np.cos(phi), 2.8 * np.sin(phi), 1.4])
        T_wc = t_map.look_at(cam, np.array([0.8, 0.2, 0.5]))
        P = (t_map.K @ np.linalg.inv(T_wc)[:3, :]).astype(np.float32)
        P_cws.append(P)
        for oi, (center, dims, yaw, cls) in enumerate(objects):
            corners = np.asarray(j_geo.box3d_corners(jnp.asarray(dims), jnp.asarray(yaw),
                                                     jnp.asarray(center)))
            hom = np.concatenate([corners, np.ones((8, 1))], 1)
            pix = hom @ P.T
            uv = pix[:, :2] / pix[:, 2:]
            box = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()])
            box += rngn.normal(0, 1.5, 4)
            row = np.zeros(82)
            row[0], row[1], row[2:6] = f, cls, box
            row[6:9] = dims * rngn.uniform(0.85, 1.15, 3)
            row[9:12] = center + rngn.normal(0, 0.08, 3)
            row[12] = yaw + rngn.normal(0, 0.05)
            row[13] = 0.9
            tracks[0 if oi == 0 and f % 2 == 0 else (2 if oi == 0 else 1)].append(row)
    return [np.asarray(t) for t in tracks], np.arange(60), np.asarray(P_cws)


@pytest.fixture(scope="module")
def mapping():
    """The scene, its constraints and the Adam solve at ITERS iterations, in
    both packages."""
    tracks, frame_ids, P_cws = t_map.build_scene()
    jtracks, jframes, jP = _jax_scene()
    sc = t_map.scene_constraints(tracks, frame_ids, P_cws)
    jsc = j_constraints.build_scene_constraints(jtracks, jframes, jP, t_map.IMG_H, t_map.IMG_W,
                                                max_objs=8, max_views=64, min_views=10)
    res = t_map.solve(sc, torch.device("cpu"), n_iters=ITERS)
    jres = j_opt.optimize_superquadrics(
        j_sq.init_params(jnp.asarray(jsc.init_translate), jnp.asarray(jsc.init_angle),
                         jnp.asarray(jsc.init_dims)),
        jnp.asarray(jsc.boxes), jnp.asarray(jsc.box_mask), jnp.asarray(jsc.view_mask),
        jnp.asarray(jsc.P_cw), jnp.asarray(jsc.optimize_mask),
        jnp.asarray(j_prior.prior_invcov_for_classes(jsc.obj_class)),
        n_iters=ITERS, n_samples=500)
    return {"torch": (tracks, frame_ids, P_cws, sc, res),
            "jax": (jtracks, jframes, jP, jsc, jres)}


def test_mapping_scene_equals_jax(mapping):
    tracks, frame_ids, P_cws = mapping["torch"][:3]
    jtracks, jframes, jP = mapping["jax"][:3]
    np.testing.assert_array_equal(jframes, frame_ids)
    np.testing.assert_array_equal(jP, P_cws)
    assert len(tracks) == len(jtracks) == 3
    for a, b in zip(tracks, jtracks):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_mapping_constraints_equal_jax(mapping):
    sc, jsc = mapping["torch"][3], mapping["jax"][3]
    for name in jsc.__dataclass_fields__:
        a, b = np.asarray(getattr(sc, name)), np.asarray(getattr(jsc, name))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-6, err_msg=name)


def test_mapping_losses_within_the_solve_bars(mapping):
    tl, jl = mapping["torch"][4].loss_log.numpy(), np.asarray(mapping["jax"][4].loss_log)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[:20], jl[:20], rtol=1e-3)


def test_mapping_ious_within_1e3(mapping):
    sc = mapping["torch"][3]
    corners, jcorners = mapping["torch"][4].corners.numpy(), np.asarray(mapping["jax"][4].corners)
    gt = {cls: t_map.box_corners(d, y, c) for c, d, y, cls in t_map.OBJECTS}
    for slot in range(3):
        cls = int(sc.obj_class[slot])
        t_iou, _ = j_hb.box3d_iou(corners[slot].astype(np.float64), gt[cls])
        j_iou, _ = j_hb.box3d_iou(jcorners[slot].astype(np.float64), gt[cls])
        assert abs(t_iou - j_iou) <= 1e-3, (slot, t_iou, j_iou)


def test_mapping_merge_equals_jax(mapping):
    tracks, frame_ids = mapping["torch"][:2]
    jtracks, jframes = mapping["jax"][:2]
    corners, jcorners = mapping["torch"][4].corners.numpy(), np.asarray(mapping["jax"][4].corners)
    order = np.argsort([-len(t) for t in tracks])
    t_merged = t_map.merge.merge_tracks([tracks[i] for i in order], list(corners[:3]), frame_ids)
    j_merged = j_merge.merge_tracks([jtracks[i] for i in order], list(jcorners[:3]), jframes)
    assert len(t_merged) == len(j_merged)


@pytest.fixture(scope="module")
def assoc_data():
    from scripts.train_associator import synthetic_scenes

    train_sc, test_sc, ds, rng = t_tas.data()
    jrng = np.random.default_rng(0)
    jtrain = synthetic_scenes(jrng, n_scenes=6, n_tracks=5, n_frames=30)
    jtest = synthetic_scenes(np.random.default_rng(99), n_scenes=2, n_tracks=5, n_frames=30)
    jds = j_datasets.AssociatorDataset(jtrain, max_tracks=8, max_dets=6, window=12)
    return {"torch": (train_sc, test_sc, ds, rng), "jax": (jtrain, jtest, jds, jrng)}


def test_associator_scenes_and_first_batch_equal_jax(assoc_data):
    train_sc, test_sc, ds, rng = assoc_data["torch"]
    jtrain, jtest, jds, jrng = assoc_data["jax"]
    for t_sc, j_sc in ((train_sc, jtrain), (test_sc, jtest)):
        assert t_sc.keys() == j_sc.keys()
        for k in t_sc:
            for a, b in zip(t_sc[k], j_sc[k]):
                np.testing.assert_array_equal(a, b)
    assert len(ds) == len(jds)
    tb, jb = next(ds.batches(16, rng)), next(jds.batches(16, jrng))
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_associator_evaluation_equals_jax(assoc_data):
    test_sc = assoc_data["torch"][1]
    jtest, jds = assoc_data["jax"][1], assoc_data["jax"][2]
    acfg = j_assoc.AssociatorConfig(
        descriptor_dim=64, keypoint_encoder=(78, 64, 64),
        gnn_layers=("self", "cross", "self", "cross"), self_gnn_layers=("self",),
        sinkhorn_iterations=30)
    jmodel = j_assoc.Associator(acfg)
    s0 = jds.get(0)
    params = jmodel.init(jax.random.key(0), *[jnp.asarray(s0[k][None]) for k in
                                               ("tracks", "track_mask", "detections", "det_mask")])
    tree = jax.tree.map(np.asarray, params["params"])
    model = t_tas.assoc_mod.build_associator(t_tas.CONFIG, flax_params=tree, device="cpu")
    name = "synthetic_0"     # the script's before-training scene
    tm = t_tas.evaluate(model, test_sc[name])
    jm = j_association.evaluate_scene(jmodel, params, jtest[name], max_tracks=8, max_dets=6,
                                      window=12)
    assert (tm.n_correct, tm.n_pred_matched, tm.n_gt_matched, tm.n_frames) == (
        jm.n_correct, jm.n_pred_matched, jm.n_gt_matched, jm.n_frames)
    assert (tm.precision, tm.recall, tm.f1) == (jm.precision, jm.recall, jm.f1)
    assert tm.n_frames > 0 and tm.n_correct > 0
