"""``odam_torch.examples.closed_loop`` against the JAX package's
``examples/closed_loop`` on the CPU.

- ``render`` / ``make_train_views``: images (uint8) exact, rows within 1e-6;
- the class-keyed oracle associator against JAX's ``ClassOracle`` (its own
  lines): log assignment, scores and matches exact, on inputs where two
  detections claim one track and one detection two tracks;
- ``segment_eval``'s held-out detections and the first 4 pipeline frames
  with the port's seeded ResNet-50 DETR converted to JAX's tree (its class
  kernel scaled by 8, so that queries clear the 0.6 threshold): valid slots and
  classes exact, the raw outputs and detections within the DETR's bar
  (atol = rtol = 2e-4, boxes in frame units), each track's frame ids and
  classes equal to JAX's pipeline's;
- ``segment_train``: 2 steps at batch 2, saved, then segment 1 resumed for
  2 more: the global step and every parameter equal those of the same 4
  steps in one process (the step itself is held to JAX's by
  ``test_torch_training.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_examples import jax_def, jax_module
from odam_torch.examples.closed_loop import closed_scene as t_scene
from odam_torch.examples.closed_loop import segment_eval as t_eval
from odam_torch.examples.closed_loop import segment_train as t_train
from odam_torch.models import convert, detr as t_detr
from odam_torch.utils import checkpoint as t_ckpt
from odam_tpu.models import detr as j_detr
from odam_tpu.models.associator import AssociatorOutput as JOutput
from odam_tpu.runtime import processor as j_proc
from torch_threads import one_torch_thread  # noqa: F401

j_scene = jax_module("closed_loop/closed_scene.py")
DETR_ATOL = DETR_RTOL = 2e-4     # tests/test_torch_detr.py's ResNet-50 bar


def test_train_views_equal_jax():
    tv, jv = t_scene.make_train_views(), j_scene.make_train_views()
    assert len(tv) == len(jv) > 0
    for (ti, tr, tT), (ji, jr, jT) in zip(tv, jv):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tT, jT)
        np.testing.assert_allclose(tr, jr, atol=1e-6, rtol=0)


def test_held_out_render_equals_jax():
    img, rows = t_scene.render(t_scene.ring_pose(t_eval.HELD_OUT_PHI))
    phi = t_eval.HELD_OUT_PHI
    cam = np.array([0.4 + 3.2 * np.cos(phi), 0.5 + 3.2 * np.sin(phi), 1.6])
    jimg, jrows = j_scene.render(j_scene.look_at(cam, np.array([0.4, 0.5, 0.4])).astype(np.float32))
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_allclose(rows, jrows, atol=1e-6, rtol=0)


def _jax_oracle():
    return jax_def("closed_loop/segment_eval.py", "ClassOracle", jnp=jnp,
                   AssociatorOutput=JOutput)()


@pytest.mark.parametrize("case", ["ties", "random0", "random1"])
def test_oracle_equals_jax_with_ties(case):
    T, W, N = 5, 3, 6
    tracks = np.full((1, T, W, 79), -1.0, np.float32)
    tmask = np.zeros((1, T), bool)
    dets = np.full((1, N, 79), -1.0, np.float32)
    dmask = np.zeros((1, N), bool)
    if case == "ties":
        # tracks 0 and 1 both class 5 (detection 0 claims both), track 2 class 1;
        # detections 0 and 1 (class 5) both claim track 0; detection 2 (class 3)
        # no track; track 3 holds class 1 but is inactive; detection 5 padded
        for t, cls, n in ((0, 5, 3), (1, 5, 2), (2, 1, 1), (3, 1, 2)):
            tracks[0, t, :n, 0] = 0
            tracks[0, t, :n, 1] = cls
        tmask[0, :3] = True
        dets[0, :5, 1] = [5, 5, 3, 1, 1]
        dmask[0, :5] = True
    else:
        rng = np.random.default_rng(int(case[-1]))
        n = rng.integers(1, W + 1, T)
        for t in range(T):
            tracks[0, t, :n[t], 0] = 0
            tracks[0, t, :n[t], 1] = rng.integers(0, 3, n[t])
        tmask[0] = rng.random(T) < 0.8
        dets[0, :, 1] = rng.integers(0, 3, N)
        dmask[0] = rng.random(N) < 0.8
    j = _jax_oracle().apply({}, *map(jnp.asarray, (tracks, tmask, dets, dmask)), 0.1)
    t = t_eval.ClassOracle()(*map(torch.from_numpy, (tracks, tmask, dets, dmask)), 0.1)
    for name, a, b in zip(("log_assignment", "scores", "matches"), t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if case == "ties":
        np.testing.assert_array_equal(t.matches[0].numpy(), [0, 0, -1, 2, 2, -1])


@pytest.fixture(scope="module")
def seeded_detr():
    """The port's seeded ResNet-50 DETR of the loop, its class kernel x 8, and
    JAX's with the same weights converted (``convert.state_dict_to_flax``)."""
    tree = convert.state_dict_to_flax(t_detr.build_detr(t_scene.make_detr(), seed=0,
                                                        device="cpu"))
    tree["class_embed"]["kernel"] = tree["class_embed"]["kernel"] * 8
    tmodel = t_detr.build_detr(t_scene.make_detr(), flax_params=tree, device="cpu")
    jmodel, _ = j_scene.make_detr()
    return jmodel, {"params": jax.tree.map(jnp.asarray, tree)}, tmodel


def test_held_out_detections_equal_jax(seeded_detr):
    jmodel, jparams, tmodel = seeded_detr
    img, _ = t_scene.render(t_scene.ring_pose(t_eval.HELD_OUT_PHI))
    x = t_scene.norm(img)[None]
    jo = jax.jit(jmodel.apply)(jparams, jnp.asarray(x))
    with torch.no_grad():
        to = tmodel(torch.from_numpy(x))
    for k in ("pred_logits", "pred_boxes", "pred_size", "pred_depth", "pred_offset"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=DETR_ATOL,
                                   rtol=DETR_RTOL, err_msg=k)
    jd = j_detr.postprocess(jo, jnp.asarray(128.0), jnp.asarray(128.0), jnp.asarray(0.6),
                            jnp.asarray(t_scene.K), max_dets=8)
    td, _ = t_eval.held_out(tmodel)
    v = td.valid[0]
    assert v.sum() >= 1     # seeded weights: the queries collapse to one detection
    np.testing.assert_array_equal(v, np.asarray(jd.valid[0]))
    np.testing.assert_array_equal(td.classes[0][v], np.asarray(jd.classes[0])[v])
    for name, scale in (("scores", 1.0), ("boxes", 128.0), ("dims", 1.0), ("t_co", 1.0)):
        np.testing.assert_allclose(getattr(td, name)[0][v] / scale,
                                   np.asarray(getattr(jd, name)[0])[v] / scale,
                                   atol=DETR_ATOL, rtol=DETR_RTOL, err_msg=name)


def test_first_pipeline_frames_equal_jax(seeded_detr):
    jmodel, jparams, tmodel = seeded_detr
    n = 4
    tpipe = t_eval.run_pipeline(tmodel, n_frames=n)
    jpipe = j_proc.OdamPipeline(jmodel, jparams, _jax_oracle(), {},
                                j_proc.PipelineConfig(**t_eval.PIPELINE))
    jpipe.init_sequence(t_scene.K, 128, 128)
    for k in range(n):
        T_wc = t_scene.ring_pose(2 * np.pi * (k + 0.5) / 24)
        img, _ = j_scene.render(T_wc)
        jpipe.process_frame(j_scene.norm(img).astype(np.float32), k, T_wc)
    tt, jt = tpipe.tracks, jpipe.tracks
    assert len(tt) == len(jt) >= 1 and sum(len(t) for t in tt) >= n
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a[:, :2], np.asarray(b)[:, :2])


def test_segment_train_resume_equals_one_process(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    for seg in (0, 1):
        out = t_train.segment_train(seg, 2, ckpt, "cpu", batch=2)
    assert out["global_step"] == 4 and t_ckpt.load_meta(ckpt)["global_step"] == 4
    params, _, _ = t_ckpt.restore(ckpt)
    resumed = t_detr.build_detr(t_scene.make_detr(use_kernels=False), flax_params=params,
                                device="cpu")
    ref = t_detr.build_detr(t_scene.make_detr(use_kernels=False), seed=0, device="cpu")
    views = t_scene.make_train_views()
    for seg in (0, 1):
        t_train.run_segment(ref, seg, 2, views, batch=2)
    got, want = resumed.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
