"""odam_torch's sequence save/restore (and reading a state the JAX package
wrote) and the offline mode (batched detection, cached association)
against odam_tpu on the CPU.  Seeded tiny models as in
``tests/test_torch_pipeline.py``; each test states its bar."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from odam_torch.parallel import mesh as t_mesh
from odam_torch.runtime import offline as t_off
from odam_torch.runtime import processor as t_proc
from odam_torch.runtime import tracker as t_trk
from odam_tpu.runtime import offline as j_off
from odam_tpu.runtime import processor as j_proc
from odam_tpu.runtime import tracker as j_trk
from test_torch_pipeline import _assert_store_equal, _assert_tracks_equal, _pose, _tiny_models
from torch_threads import one_torch_thread  # noqa: F401

K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)


def _frames(n, shape=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=shape + (3,), dtype=np.uint8) for _ in range(n)]


def _run(pipe, frames, first=0):
    for f, frame in enumerate(frames, start=first):
        pipe.process_frame(frame, f, _pose(f))


def test_save_restore_equals_a_straight_run(tmp_path):
    """Three frames, save, restore into a fresh pipeline, three more: the
    store, the log and the tracks equal six straight frames (ids exact,
    rows within 1e-5), the restored host flag takes the association branch
    on the first restored frame, and the pickle holds numpy arrays and
    plain containers only."""
    import pickle

    frames = _frames(6, seed=3)
    _, straight = _tiny_models()
    straight.init_sequence(K, 64, 64)
    _run(straight, frames)

    _, first = _tiny_models()
    first.init_sequence(K, 64, 64)
    _run(first, frames[:3])
    path = str(tmp_path / "state.pkl")
    first.save_sequence_state(path)
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert type(state["store"]) is tuple and all(isinstance(a, np.ndarray)
                                                 for a in state["store"] + state["log"])

    _, resumed = _tiny_models()
    resumed.restore_sequence_state(path)
    assert resumed.sequence["has_tracks"] == bool(state["store"][7] > 0)
    _run(resumed, frames[3:], first=3)
    _assert_store_equal(resumed.sequence["store"], jax.tree.map(
        np.asarray, straight.sequence["store"]), atol=1e-5)
    for name in t_trk.FrameLog._fields:
        np.testing.assert_allclose(getattr(resumed.sequence["log"], name).numpy(),
                                   getattr(straight.sequence["log"], name).numpy(), atol=1e-5)
    assert len(resumed.tracks) == len(straight.tracks) > 0
    for a, b in zip(resumed.tracks, straight.tracks):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert resumed.sequence["usable_frames"] == straight.sequence["usable_frames"]


def test_state_files_cross_between_packages(tmp_path):
    """A state the JAX package saved after three frames, restored by the
    port, gives JAX's next three frames (ids exact, rows within 1e-4, the
    whole-step bar); and the port's state restores in the JAX package to
    the same effect."""
    frames = _frames(6, seed=4)
    jpipe, tpipe = _tiny_models()
    for pipe in (jpipe, tpipe):
        pipe.init_sequence(K, 64, 64)
        _run(pipe, frames[:3])
    jpath, tpath = str(tmp_path / "jax.pkl"), str(tmp_path / "torch.pkl")
    jpipe.save_sequence_state(jpath)
    tpipe.save_sequence_state(tpath)

    jnext, tnext = _tiny_models()
    tnext.restore_sequence_state(jpath)      # the JAX package's pickle, read by the port
    jnext.restore_sequence_state(tpath)      # the port's pickle, read by the JAX package
    for pipe in (jpipe, tpipe, jnext, tnext):
        _run(pipe, frames[3:], first=3)
    _assert_tracks_equal(jpipe, tnext, atol=1e-4)
    _assert_tracks_equal(jnext, tpipe, atol=1e-4)
    assert tnext.sequence["usable_frames"] == jpipe.sequence["usable_frames"]


# ------------------------------------------------------------------ offline

def _offline_parts():
    jpipe, tpipe = _tiny_models()
    jd = j_off.BatchedDetector(jpipe.detr_model, jpipe.detr_params, jpipe.cfg, batch_size=4)
    td = t_off.BatchedDetector(tpipe.detr, tpipe.cfg, batch_size=4, device="cpu")
    jc = j_off.CachedDetectionPipeline(jpipe.assoc_model, jpipe.assoc_params, jpipe.cfg)
    tc = t_off.CachedDetectionPipeline(tpipe.associator, tpipe.cfg, device="cpu")
    return jpipe, tpipe, jd, td, jc, tc


def test_batched_detector_pads_partial_batches():
    """Six frames in batches of 4 (the last padded by repeating its frame),
    as tests/test_offline.py has it: six batch-1 Detections, each equal to
    JAX's (valid and classes exact, floats within 1e-4) and to the port's
    own frame-by-frame detections.  A one-rank mesh gives the same
    detections; a batch that does not divide over the mesh's dp axis
    raises."""
    jpipe, tpipe, jd, td, _, _ = _offline_parts()
    frames = _frames(6, seed=5)
    jout = jd.detect_frames(frames, K, 64.0, 64.0)
    tout = td.detect_frames(frames, K, 64.0, 64.0)
    assert len(tout) == len(jout) == 6
    assert tout[0].valid.shape == (1, tpipe.cfg.max_dets)
    for i, (t, j) in enumerate(zip(tout, jout)):
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        v = t.valid.numpy()
        np.testing.assert_array_equal(t.classes.numpy()[v], np.asarray(j.classes)[v])
        for name in ("scores", "boxes", "dims", "t_co", "angle_deg", "features"):
            np.testing.assert_allclose(getattr(t, name).numpy()[v],
                                       np.asarray(getattr(j, name))[v], atol=1e-4,
                                       err_msg=f"frame {i} {name}")
        with torch.no_grad():
            one = t_proc.detect_frame(tpipe.cfg, tpipe.detr, t_proc.device_images(
                frames[i][None], tpipe.device, tpipe._mean, tpipe._std, torch.float32),
                torch.from_numpy(K), 64.0, 64.0)
        np.testing.assert_array_equal(one.valid.numpy(), t.valid.numpy())
        np.testing.assert_allclose(one.boxes.numpy()[v], t.boxes.numpy()[v], atol=1e-4)
    mesh = t_mesh.make_mesh(device="cpu")
    meshed = t_off.BatchedDetector(tpipe.detr, tpipe.cfg, batch_size=4, mesh=mesh,
                                   device="cpu").detect_frames(frames, K, 64.0, 64.0)
    for t, m in zip(tout, meshed):
        for name, x, y in zip(t._fields, t, m):
            assert torch.equal(x, y), name
    three = t_mesh.Mesh(("dp",), (3,), 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        t_off.BatchedDetector(tpipe.detr, tpipe.cfg, batch_size=4, mesh=three, device="cpu")


def test_offline_tracks_equal_online_and_jax():
    """Five frames: the port's offline tracks equal its online tracks (ids
    exact, rows within 1e-4: batch-4 and batch-1 forwards sum in another
    order) and JAX's offline tracks (the same bar); run_scene_offline gives
    the pickle's schema with the same tracks as JAX's."""
    jpipe, tpipe, jd, td, jc, tc = _offline_parts()
    frames = _frames(5, seed=6)
    tpipe.init_sequence(K, 64, 64)
    _run(tpipe, frames)
    for pipe, det in ((jc, jd), (tc, td)):
        pipe.init_sequence(K, 64, 64)
        for f, d in enumerate(det.detect_frames(frames, K, 64.0, 64.0)):
            pipe.process_detections(d, f, _pose(f))
    _assert_tracks_equal(jc, tc, atol=1e-4)
    ot, on = t_trk.drain_log(tc.sequence["log"]), t_trk.drain_log(tpipe.sequence["log"])
    assert list(ot) == list(on) and len(ot) > 0
    for tid in on:
        np.testing.assert_allclose(ot[tid], on[tid], atol=1e-4)
    assert tc.host_syncs == 0
    with pytest.raises(NotImplementedError, match="process_detections"):
        tc.process_frame(frames[0], 0, _pose(0))

    cfg = dict(optim_iters=4, optim_samples=64, min_views=1, max_objs=8, max_views=16)
    jd.cfg = jc.cfg = dataclasses.replace(jc.cfg, **cfg)
    td.cfg = tc.cfg = dataclasses.replace(tc.cfg, **cfg)
    jc._assoc_step = jc._build_assoc_step()
    poses = [_pose(f) for f in range(5)]
    jout = j_off.run_scene_offline(jd, jc, frames, list(range(5)), poses, K, 64.0, 64.0)
    tout = t_off.run_scene_offline(td, tc, frames, list(range(5)), poses, K, 64.0, 64.0)
    assert set(jout) <= set(tout) and len(tout["tracks"]) == len(jout["tracks"]) > 0
    for a, b in zip(tout["tracks"], jout["tracks"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    for a, b in zip(tout["bboxes_dl"], jout["bboxes_dl"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert all(np.isfinite(b).all() for b in tout["bboxes_qc"])
    assert isinstance(jpipe, j_proc.OdamPipeline) and isinstance(j_trk.init_store(1, 1),
                                                                   j_trk.TrackStore)
