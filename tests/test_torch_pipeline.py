"""odam_torch's track store and online step against odam_tpu on the CPU:
tracker units, the associator input, the whole step on a seeded tiny model,
and the committed rehearsal checkpoints on a committed scene."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from odam_torch.models import associator as t_assoc
from odam_torch.models import detr as t_detr
from odam_torch.runtime import processor as t_proc
from odam_torch.runtime import tracker as t_trk
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import detr as j_detr
from odam_tpu.runtime import processor as j_proc
from odam_tpu.runtime import tracker as j_trk
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENE = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard", "scans", "scene9700_00")


def _assert_store_equal(ts, js, atol=0.0):
    for name in j_trk.TrackStore._fields:
        t, j = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        if t.dtype.kind == "f":
            np.testing.assert_allclose(t, j, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)


def _rows(rng, n, frame):
    rows = rng.normal(size=(n, 82)).astype(np.float32)
    rows[:, 0] = frame
    return rows


def test_append_rows_matches_loop_with_rolling_windows():
    """The vectorised append equals JAX's row-by-row loop, through windows
    that fill and roll, with invalid rows pointing at live slots."""
    rng = np.random.default_rng(0)
    T, W, N = 4, 3, 5
    ts, js = t_trk.init_store(T, W, "cpu"), j_trk.init_store(T, W)
    for frame in range(6):
        rows = _rows(rng, N, frame)
        slots = rng.permutation(T + 1)[:N].astype(np.int32) - 1     # unique, one may be -1
        valid = (rng.random(N) < 0.8) & (slots >= 0)
        ts = t_trk.append_rows(ts, torch.from_numpy(rows), torch.from_numpy(slots),
                               torch.from_numpy(valid))
        js = j_trk.append_rows(js, jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(valid))
        _assert_store_equal(ts, js)
    assert int(ts.length.max()) == W       # some window rolled


def test_assign_new_slots_lru_eviction_with_protected_slots():
    rng = np.random.default_rng(1)
    T, W, N = 6, 4, 8
    ts, js = t_trk.init_store(T, W, "cpu"), j_trk.init_store(T, W)
    for frame, n_new in ((0, 4), (1, 2), (2, 3), (3, 5), (4, 8)):
        is_new = np.zeros(N, bool)
        is_new[rng.permutation(N)[:n_new]] = True
        protected = rng.random(T) < 0.3
        ts, t_slots = t_trk.assign_new_slots(ts, torch.from_numpy(is_new),
                                             torch.from_numpy(protected))
        js, j_slots = j_trk.assign_new_slots(js, jnp.asarray(is_new), jnp.asarray(protected))
        np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
        _assert_store_equal(ts, js)
        rows = _rows(rng, N, frame // 2)        # repeated frame ids: LRU ties
        ok = is_new & (np.asarray(j_slots) >= 0)
        ts = t_trk.append_rows(ts, torch.from_numpy(rows), t_slots, torch.from_numpy(ok))
        js = j_trk.append_rows(js, jnp.asarray(rows), j_slots, jnp.asarray(ok))
        _assert_store_equal(ts, js)
    assert int(ts.n_evicted) > 0 and int(ts.n_dropped) > 0


def test_frame_log_fills_and_drains():
    rng = np.random.default_rng(2)
    tl, jl = t_trk.init_log(3, 4, "cpu"), j_trk.init_log(3, 4)
    for frame in range(5):                  # two frames past capacity are lost
        rows = _rows(rng, 4, frame)
        ids = rng.integers(-1, 3, 4).astype(np.int32)
        tl = t_trk.log_frame(tl, torch.from_numpy(rows), torch.from_numpy(ids))
        jl = j_trk.log_frame(jl, jnp.asarray(rows), jnp.asarray(ids))
    for name in j_trk.FrameLog._fields:
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)))
    td, jd = t_trk.drain_log(tl), j_trk.drain_log(jl)
    assert list(td) == list(jd) and int(tl.n_lost) == 2
    for tid in jd:
        np.testing.assert_array_equal(td[tid], jd[tid])


def _pose(f):
    T = np.eye(4, dtype=np.float32)
    phi = 0.1 * f
    T[:3, :3] = [[np.cos(phi), 0, np.sin(phi)], [0, 1, 0], [-np.sin(phi), 0, np.cos(phi)]]
    T[:3, 3] = [0.2 * f, 0.0, -0.5]
    return T


def test_prepare_track_inputs_matches():
    """Mean-state surface re-projection (1000 samples) and re-encoding.
    atol 1e-4 on normalized coordinates: float32 cumsums in another order can
    move a sample to the neighbouring grid angle, which shifts a bbox extreme
    by far less than that."""
    rng = np.random.default_rng(3)
    T, W, N = 8, 5, 6
    ts, js = t_trk.init_store(T, W, "cpu"), j_trk.init_store(T, W)
    for frame in range(7):
        rows = _rows(rng, N, frame)
        rows[:, 6:9] = rng.uniform(0.2, 1.5, size=(N, 3))
        rows[:, 9:12] = rng.normal(size=(N, 3)) + [0, 0, 3]
        slots = rng.permutation(T)[:N].astype(np.int32)
        valid = rng.random(N) < 0.7
        ts = t_trk.append_rows(ts, torch.from_numpy(rows), torch.from_numpy(slots),
                               torch.from_numpy(valid))
        js = j_trk.append_rows(js, jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(valid))
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    T_wc = _pose(2)
    ref = j_proc.prepare_track_inputs(js, jnp.asarray(T_wc), jnp.asarray(K),
                                      jnp.asarray(640.0), jnp.asarray(480.0), n_samples=1000)
    out = t_proc.prepare_track_inputs(ts, torch.from_numpy(T_wc), torch.from_numpy(K),
                                      640.0, 480.0, n_samples=1000)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _tiny_models(seed=0):
    dkw = dict(num_classes=8, num_queries=8, hidden_dim=32, nheads=4, enc_layers=1,
               dec_layers=1, dim_feedforward=32, aux_loss=False)
    jdetr = j_detr.DETR(j_detr.DETRConfig(**dkw))
    dparams = jdetr.init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3)))
    akw = dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
               self_gnn_layers=("self",), sinkhorn_iterations=20)
    jassoc = j_assoc.Associator(j_assoc.AssociatorConfig(**akw))
    T, W, N = 8, 6, 5
    aparams = jassoc.init(jax.random.key(seed + 1), jnp.full((1, T, W, 79), -1.0),
                          jnp.zeros((1, T), bool), jnp.full((1, N, 79), -1.0),
                          jnp.zeros((1, N), bool))
    pkw = dict(detect_threshold=0.0, score_threshold=0.0, max_tracks=T, max_dets=N, window=W,
               track_bbox_samples=64, max_log_frames=16)
    jpipe = j_proc.OdamPipeline(jdetr, dparams, jassoc, aparams, j_proc.PipelineConfig(**pkw))
    tpipe = t_proc.OdamPipeline(
        t_detr.build_detr(t_detr.DETRConfig(**dkw), flax_params=jax.tree.map(np.asarray, dparams),
                          device="cpu"),
        t_assoc.build_associator(t_assoc.AssociatorConfig(**akw),
                                 flax_params=jax.tree.map(np.asarray, aparams), device="cpu"),
        t_proc.PipelineConfig(**pkw), device="cpu")
    return jpipe, tpipe


def _assert_tracks_equal(jpipe, tpipe, atol):
    jd = j_trk.drain_log(jpipe.sequence["log"])
    td = t_trk.drain_log(tpipe.sequence["log"])
    assert list(td) == list(jd), (list(td), list(jd))
    for tid in jd:
        assert td[tid].shape == jd[tid].shape, tid
        np.testing.assert_allclose(td[tid], jd[tid], atol=atol, err_msg=f"track {tid}")
    assert len(tpipe.tracks) == len(jpipe.tracks)


def test_whole_step_matches_over_six_frames():
    """Seeded tiny models, every transport (uint8 RGB, float32, YUV 4:2:0);
    track ids exact, rows within atol 1e-4 (pixels and metres)."""
    from odam_torch.data.transforms import rgb_to_yuv420

    jpipe, tpipe = _tiny_models()
    K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    rgb = [rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(6)]
    frames = [rgb[0], rgb[1], rgb_to_yuv420(rgb[2]), rgb_to_yuv420(rgb[3]),
              ((rgb[4] / 255.0 - 0.45) / 0.225).astype(np.float32), rgb[5]]
    for pipe in (jpipe, tpipe):
        pipe.init_sequence(K, 64, 64)
    for f, frame in enumerate(frames):
        jr = jpipe.process_frame(frame, f, _pose(f))
        tr = tpipe.process_frame(frame, f, _pose(f))
        assert int(tr.n_detections) == int(jr.n_detections)
        np.testing.assert_array_equal(tr.store.track_id.numpy(), np.asarray(jr.store.track_id))
    _assert_store_equal(tpipe.sequence["store"], jpipe.sequence["store"], atol=1e-4)
    _assert_tracks_equal(jpipe, tpipe, atol=1e-4)
    assert tpipe.overflow_report() == jpipe.overflow_report()
    assert tpipe.host_syncs == 0      # the CPU run waits on nothing


def _scene_frames(n):
    from PIL import Image

    K = np.loadtxt(os.path.join(SCENE, "frames", "intrinsic", "intrinsic_color.txt"))[:3, :3]
    frames = []
    for i in range(n):
        img = np.asarray(Image.open(os.path.join(SCENE, "frames", "color", f"{i}.jpg")))
        pose = np.loadtxt(os.path.join(SCENE, "frames", "pose", f"{i}.txt")).astype(np.float32)
        frames.append((img, pose))
    return K.astype(np.float32), frames


def test_committed_checkpoints_on_committed_scene():
    """The committed rehearsal detector and associator (TinyBackbone stage 3,
    16 queries, hidden 64; 64-d associator), restored with the JAX package's
    checkpoint reader and converted, run all 32 frames of scene9700_00 in
    both pipelines at the default PipelineConfig.  Track ids exact, rows
    within atol 1e-3 (pixels of a 192-px frame, metres)."""
    from odam_tpu.utils import checkpoint

    dkw = dict(num_classes=8, num_queries=16, hidden_dim=64, nheads=4, enc_layers=2,
               dec_layers=2, dim_feedforward=256, backbone="tiny", backbone_stage=3)
    akw = dict(descriptor_dim=64, keypoint_encoder=(78, 64, 64),
               gnn_layers=("self", "cross", "self", "cross"), self_gnn_layers=("self",),
               sinkhorn_iterations=30)
    jdetr = j_detr.DETR(j_detr.DETRConfig(**dkw, dropout=0.0))
    jassoc = j_assoc.Associator(j_assoc.AssociatorConfig(**akw))
    dlike = jax.eval_shape(lambda k: jdetr.init(k, jnp.zeros((1, 64, 64, 3))), jax.random.key(0))
    alike = jax.eval_shape(
        lambda k: jassoc.init(k, jnp.full((1, 4, 4, 79), -1.0), jnp.zeros((1, 4), bool),
                              jnp.full((1, 4, 79), -1.0), jnp.zeros((1, 4), bool)),
        jax.random.key(1))
    dparams = checkpoint.restore(os.path.join(ROOT, "artifacts", "rehearsal_hard_detr_ckpt"), dlike)
    aparams = checkpoint.restore(os.path.join(ROOT, "artifacts", "rehearsal_hard_assoc_ckpt"),
                                 alike)
    tdetr = t_detr.build_detr(t_detr.DETRConfig(**dkw),
                              flax_params=jax.tree.map(np.asarray, dparams), device="cpu")
    tassoc = t_assoc.build_associator(t_assoc.AssociatorConfig(**akw),
                                      flax_params=jax.tree.map(np.asarray, aparams), device="cpu")
    # every leaf of both checkpoints maps to exactly one tensor
    assert len(jax.tree.leaves(dparams)) == len(tdetr.state_dict())
    assert len(jax.tree.leaves(aparams)) == len(tassoc.state_dict())

    pcfg = dict(max_log_frames=64)
    jpipe = j_proc.OdamPipeline(jdetr, dparams, jassoc, aparams, j_proc.PipelineConfig(**pcfg))
    tpipe = t_proc.OdamPipeline(tdetr, tassoc, t_proc.PipelineConfig(**pcfg), device="cpu")
    K, frames = _scene_frames(32)
    for pipe in (jpipe, tpipe):
        pipe.init_sequence(K, 192, 192)
    for f, (img, pose) in enumerate(frames):
        jpipe.process_frame(img, f, pose)
        tpipe.process_frame(img, f, pose)
    _assert_tracks_equal(jpipe, tpipe, atol=1e-3)
    assert len(tpipe.tracks) >= 2 and sum(len(t) for t in tpipe.tracks) >= 32
    assert tpipe.overflow_report() == jpipe.overflow_report()
