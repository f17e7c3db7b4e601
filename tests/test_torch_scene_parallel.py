"""odam_torch's scene-parallel lanes on the CPU: the lane-batched tracker,
NMS, postprocess and attention routing against their one-scene forms, the
``SceneParallelRunner`` against the port's serial ``OdamPipeline`` and
against JAX's ``SceneParallelRunner``, and ``run_processor --scene_parallel``
against the serial CLI.  Each test states its bar.

torch's ``vmap`` warns ("There is a performance drop ...") when an op has
no batching rule and it loops over the lanes instead; that loop is what the
lane step must not have, so the warning is an error in every test here.
"""
import functools
import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch import config as t_config
from odam_torch.models import associator as t_assoc
from odam_torch.models import convert
from odam_torch.models import detr as t_detr
from odam_torch.ops import attention as t_attn
from odam_torch.ops import cuda_attention as t_ca
from odam_torch.ops import lap as t_lap
from odam_torch.runtime import processor as t_proc
from odam_torch.runtime import scene_parallel as t_sp
from odam_torch.runtime import tracker as t_trk
from odam_torch.scripts import run_processor as t_run
from odam_torch.utils.host_boxes import robust_box3d_iou
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import detr as j_detr
from odam_tpu.parallel import mesh as j_mesh
from odam_tpu.runtime import processor as j_proc
from odam_tpu.runtime import scene_parallel as j_sp
from test_torch_pipeline import _pose

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HARD = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard")
ART = os.path.join(ROOT, "artifacts", "torch")
HARD_SCENES = ("scene9700_00", "scene9701_00", "scene9702_00")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in tests/test_torch_cli.py: the suite runs on
    several workers, and torch's threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- units

def _store_after(rng, T, W, N, frames):
    """A store filled by ``frames`` random spawns and appends."""
    store = t_trk.init_store(T, W, "cpu")
    for f in range(frames):
        store, slots = t_trk.assign_new_slots(store, torch.from_numpy(rng.random(N) < 0.5))
        rows = torch.from_numpy(rng.normal(size=(N, 82)).astype(np.float32))
        rows[:, 0] = f
        store = t_trk.append_rows(store, rows, slots, slots >= 0)
    return store


def _assert_trees_equal(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {name}"


def test_tracker_lanes_equal_per_lane_calls():
    """Spawn, append, mean state and the log write for 3 lanes at once equal
    3 one-scene calls: ints exact, floats bit-equal.  Lane 1's frame is
    padding: its log keeps its rows, ids, count and n_lost.  Lane 2's log is
    full: the frame counts in its n_lost, as one scene's would."""
    rng = np.random.default_rng(0)
    T, W, N, P = 6, 3, 8, 3
    singles = [_store_after(rng, T, W, N, frames) for frames in (0, 2, 5)]   # LRU and rolls
    stores = t_trk.stack_lanes(singles)
    is_new = torch.from_numpy(rng.random((P, N)) < 0.7)
    protected = torch.from_numpy(rng.random((P, T)) < 0.6)
    got, got_slots = t_trk.assign_new_slots_lanes(stores, is_new, protected)
    rows = torch.from_numpy(rng.normal(size=(P, N, 82)).astype(np.float32))
    got = t_trk.append_rows_lanes(got, rows, got_slots, got_slots >= 0)
    got_mean = t_trk.mean_state_lanes(got)
    for p in range(P):
        want, slots = t_trk.assign_new_slots(singles[p], is_new[p], protected[p])
        assert torch.equal(got_slots[p], slots)
        want = t_trk.append_rows(want, rows[p], slots, slots >= 0)
        _assert_trees_equal(t_trk.lane_of(got, p), want, f"lane {p}")
        for x, y in zip(got_mean, t_trk.mean_state(want)):
            assert torch.equal(x[p], y)
    assert int(got.n_evicted.sum()) > 0 and int(got.n_dropped.sum()) > 0

    cap = 3
    single_logs = [t_trk.init_log(cap, N, "cpu") for _ in range(P)]
    for p, n_before in enumerate((1, 2, 3)):
        for f in range(n_before):
            single_logs[p] = t_trk.log_frame(
                single_logs[p], torch.full((N, 82), float(f)), torch.arange(N, dtype=torch.int32))
    logs = t_trk.stack_lanes([t_trk.FrameLog(*[x.clone() for x in lg]) for lg in single_logs])
    ids = torch.from_numpy(rng.integers(-1, 4, (P, N)).astype(np.int32))
    valid = torch.tensor([True, False, True])
    logs = t_trk.log_frame_lanes(logs, rows, ids, valid)
    for p in range(P):
        want = single_logs[p]
        if valid[p]:
            want = t_trk.log_frame(t_trk.FrameLog(*[x.clone() for x in want]), rows[p], ids[p])
        _assert_trees_equal(t_trk.lane_of(logs, p), want, f"log lane {p}")
    assert logs.count.tolist() == [2, 2, 3] and logs.n_lost.tolist() == [0, 0, 1]
    np.testing.assert_array_equal(logs.rows[1, 2].numpy(), 0.0)   # the padded lane's slot


def _candidates(rng, B, Q):
    classes = torch.from_numpy(rng.integers(0, 3, (B, Q)).astype(np.int32))
    scores = torch.from_numpy(rng.random((B, Q)).astype(np.float32))
    scores[:, 3] = scores[:, 4]                                   # a tie on rank
    t_co = torch.from_numpy((rng.normal(size=(B, Q, 3)) * 0.4 + [0, 0, 3]).astype(np.float32))
    dims = torch.from_numpy(rng.uniform(0.3, 1.2, (B, Q, 3)).astype(np.float32))
    xy = rng.uniform(0, 150, (B, Q, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(20, 80, (B, Q, 2))], -1)
                             .astype(np.float32))
    valid = torch.from_numpy(rng.random((B, Q)) < 0.8)
    return classes, scores, t_co, dims, boxes, valid


def test_batched_nms_equals_per_image_and_sequential():
    """nms_3d_mask over a batch of 4 images equals it per image and the
    literal greedy sweep per image, exactly."""
    args = _candidates(np.random.default_rng(1), 4, 16)
    keep = t_detr.nms_3d_mask(*args)
    for b in range(4):
        one = [a[b] for a in args]
        assert torch.equal(keep[b], t_detr.nms_3d_mask(*one)), b
        assert torch.equal(keep[b], t_detr._nms_3d_mask_sequential(*one)), b
    assert 0 < int(keep.sum()) < int(args[-1].sum())          # some suppressed


def test_postprocess_takes_one_intrinsic_matrix_per_image():
    """postprocess with K [B, 3, 3] equals B calls with each image's [3, 3]:
    every field exact (the same float ops on the same values)."""
    rng = np.random.default_rng(2)
    B, Q, C = 3, 12, 6
    outputs = {"pred_logits": rng.normal(size=(B, Q, C + 1)) * 3,
               "pred_boxes": rng.uniform(0.2, 0.8, (B, Q, 4)) * [1, 1, 0.3, 0.3],
               "pred_offset": rng.normal(size=(B, Q, 2)) * 0.01,
               "pred_angle": rng.normal(size=(B, Q, 30)),
               "pred_size": rng.uniform(0.3, 1.5, (B, Q, 3)),
               "pred_depth": rng.uniform(1, 4, (B, Q, 1)),
               "pred_obj_features": rng.normal(size=(B, Q, 8))}
    outputs = {k: torch.from_numpy(v.astype(np.float32)) for k, v in outputs.items()}
    Ks = torch.from_numpy(np.stack([[[f, 0, 60 + 5 * b], [0, f * 1.1, 50], [0, 0, 1]]
                                    for b, f in enumerate((100.0, 150.0, 90.0))]
                                   ).astype(np.float32))
    got = t_detr.postprocess(outputs, 128.0, 96.0, 0.2, Ks, max_dets=8)
    for b in range(B):
        one = t_detr.postprocess({k: v[b:b + 1] for k, v in outputs.items()}, 128.0, 96.0,
                                 0.2, Ks[b], max_dets=8)
        for name, x, y in zip(got._fields, got, one):
            assert torch.equal(x[b:b + 1], y), (b, name)
    assert bool(got.valid.any())


@pytest.mark.parametrize("B,lanes,kernel", [(1, 1, True), (2, 1, True), (3, 1, False),
                                            (4, 4, True), (8, 4, True), (6, 2, False),
                                            (8, 8, True), (16, 2, False)])
def test_mha_core_routes_on_the_lane_batch(B, lanes, kernel):
    """A kernel wrapper (its plain version on the CPU, counted) takes the call
    iff B / lanes <= KERNEL_MAX_BATCH, for both key lengths; the output
    equals the plain path's."""
    rng = np.random.default_rng(B * 10 + lanes)
    for Lk, name in ((40, "fused_attention"), (300, "flash_attention")):
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((B, 7, 32), (B, Lk, 32), (B, Lk, 32)))
        kpm = torch.zeros(B, Lk, dtype=torch.bool)
        kpm[:, -3:] = True
        t_ca.reset_counts()
        out = t_attn.mha_core(q, k, v, 4, kpm, lanes=lanes)
        assert t_ca.PLAIN_CALLS[name] == int(kernel), (Lk, dict(t_ca.PLAIN_CALLS))
        ref = t_attn.mha_core(q, k, v, 4, kpm, use_kernels=False)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="does not divide"):
        t_attn.mha_core(q, k, v, 4, kpm, lanes=B + 1)


def test_greedy_decode_batched_equals_per_matrix():
    """The greedy peel over a batch of 3 score matrices equals 3 calls."""
    rng = np.random.default_rng(3)
    score = torch.from_numpy(rng.random((3, 6, 5)).astype(np.float32))
    rm = torch.from_numpy(rng.random((3, 6)) < 0.8)
    cm = torch.from_numpy(rng.random((3, 5)) < 0.8)
    got = t_lap.greedy_peel_match(score, 0.2, rm, cm)
    for b in range(3):
        assert torch.equal(got[b], t_lap.greedy_peel_match(score[b], 0.2, rm[b], cm[b]))


def test_lane_step_runs_without_a_vmap_fallback():
    """One lane step of 2 lanes, both branches of the association, with
    every warning an error: no op of the vmapped row, track-input and store
    functions falls back to a loop over the lanes."""
    (_, (tdetr, tassoc), pkw) = _seeded_tiny_models()
    cfg = t_proc.PipelineConfig(**pkw)
    scenes = _tiny_scenes((2, 2))
    runner = t_sp.SceneParallelRunner(tdetr, tassoc, cfg, 2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        stores, logs = runner.run_frames(scenes, 64, 64)
    assert logs.count.tolist() == [2, 2] and int(stores.count.min()) > 0


# ---------------------------------------------------- runner against serial

def _hard_scene(seq_id, n):
    from PIL import Image

    frames_dir = os.path.join(HARD, "scans", seq_id, "frames")
    K = np.loadtxt(os.path.join(frames_dir, "intrinsic", "intrinsic_color.txt"))[:3, :3]
    names = sorted(os.listdir(os.path.join(frames_dir, "color")),
                   key=lambda s: int(s.split(".")[0]))[:n]
    return {"frames": [np.asarray(Image.open(os.path.join(frames_dir, "color", nm)))
                       for nm in names],
            "frame_ids": [int(nm.split(".")[0]) for nm in names],
            "T_wcs": [np.loadtxt(os.path.join(frames_dir, "pose", nm.split(".")[0] + ".txt"))
                      .astype(np.float32) for nm in names],
            "K": K.astype(np.float32)}


def _assert_outputs_close(a, b, row_atol, what):
    assert len(a["tracks"]) == len(b["tracks"]) >= 1, what
    for k, (x, y) in enumerate(zip(a["tracks"], b["tracks"])):
        assert x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x[:, :2], y[:, :2], err_msg=f"{what} track {k}")
        np.testing.assert_allclose(x, y, atol=row_atol, err_msg=f"{what} track {k}")
    for x, y in zip(a["bboxes_dl"], b["bboxes_dl"]):
        np.testing.assert_allclose(x, y, atol=1e-3, err_msg=what)
    ious = [robust_box3d_iou(x, y) for x, y in zip(a["bboxes_qc"], b["bboxes_qc"])]
    assert min(ious) >= 0.95, (what, ious)


def test_runner_equals_serial_pipeline_on_rehearsal_scenes():
    """The committed rehearsal weights on the three hard scenes cut to 4 / 2
    / 3 frames, in 4 lanes (one of them padding), against the serial
    pipeline scene by scene.  Before the scene end: stores with ints exact
    and floats within 1e-3, drained logs with ids exact and rows within 1e-3
    (pixels of a 192-px frame, metres; the lanes run the detector at B = 4,
    the serial pipeline at B = 1).  After it (8 objects of 8 views, 10 Adam
    iterations of 100 samples): tracks with frame ids and classes exact and
    rows within 1e-3, bboxes_dl within 1e-3, bboxes_qc at IoU >= 0.95 (the
    Adam solve is chaotic at the rounding level)."""
    cfg_yaml = t_config.merge_cfg([os.path.join(HARD, "rehearsal.yaml")])
    detr, assoc = t_run.build_models(cfg_yaml, os.path.join(ART, "rehearsal_hard_detr.npz"),
                                     os.path.join(ART, "rehearsal_hard_assoc.npz"), "exact",
                                     torch.device("cpu"))
    cfg = t_proc.PipelineConfig(max_objs=8, max_views=8, min_views=2, optim_iters=10,
                                optim_samples=100, max_log_frames=8)
    scenes = [_hard_scene(s, n) for s, n in zip(HARD_SCENES, (4, 2, 3))]
    runner = t_sp.SceneParallelRunner(detr, assoc, cfg, 4, device="cpu")
    lap_calls = t_lap.PLAIN_CALLS["lap_solve"]
    stores, logs = runner.run_frames(scenes, 192.0, 192.0)
    lap_calls = t_lap.PLAIN_CALLS["lap_solve"] - lap_calls
    outs = runner.finalize(scenes, stores, logs, 192.0, 192.0)
    pipe = t_proc.OdamPipeline(detr, assoc, cfg, device="cpu")
    for lane, s in enumerate(scenes):
        pipe.init_sequence(s["K"], 192, 192)
        for img, fid, T_wc in zip(s["frames"], s["frame_ids"], s["T_wcs"]):
            pipe.process_frame(img, fid, T_wc)
        for name, x, y in zip(t_trk.TrackStore._fields, t_trk.lane_of(stores, lane),
                              pipe.sequence["store"]):
            if x.dtype.is_floating_point:
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-3, err_msg=name)
            else:
                assert torch.equal(x, y), (lane, name)
        got = t_trk.drain_log(t_trk.lane_of(logs, lane))
        want = t_trk.drain_log(pipe.sequence["log"])
        assert list(got) == list(want) and len(want) >= 2, (lane, list(got), list(want))
        for tid in want:
            np.testing.assert_array_equal(got[tid][:, :2], want[tid][:, :2])
            np.testing.assert_allclose(got[tid], want[tid], atol=1e-3, err_msg=f"track {tid}")
        serial = pipe.optim_process(pipe.tracks)
        serial = pipe.optim_process(pipe.merge_process(serial))
        _assert_outputs_close(outs[lane], serial, 1e-3, f"lane {lane}")
        assert outs[lane]["overflow_report"] == pipe.overflow_report()
    # the padded lane logged nothing; every real lane logged its frames
    assert logs.count.tolist() == [4, 2, 3, 0]
    assert lap_calls == 4          # one exact decode of every lane a step, 4 steps


# ---------------------------------------------------- runner against JAX's

def _seeded_tiny_models():
    """The models and PipelineConfig of tests/test_torch_pipeline.py's
    ``_tiny_models`` (a DETR with 8 queries and hidden 32, a 32-d
    associator; thresholds 0) on TinyBackbone and with the greedy decode,
    whose batched form the lanes run on the device (the lanes' exact decode
    is held to the serial pipeline above), and the port's seeded Flax-like
    weights handed to JAX as its variables.  Both choices keep JAX's init
    and compile inside the test budget."""
    dkw = dict(num_classes=8, num_queries=8, hidden_dim=32, nheads=4, enc_layers=1,
               dec_layers=1, dim_feedforward=32, aux_loss=False, backbone="tiny",
               backbone_stage=3)
    akw = dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
               self_gnn_layers=("self",), sinkhorn_iterations=20, decode="greedy")
    pkw = dict(detect_threshold=0.0, score_threshold=0.0, max_tracks=8, max_dets=5, window=6,
               track_bbox_samples=64, max_log_frames=16)
    tdetr = t_detr.build_detr(t_detr.DETRConfig(**dkw), seed=0, device="cpu")
    tassoc = t_assoc.build_associator(t_assoc.AssociatorConfig(**akw), seed=1, device="cpu")

    def variables(model):
        return {"params": jax.tree.map(jnp.asarray, convert.state_dict_to_flax(model))}

    return ((j_detr.DETR(j_detr.DETRConfig(**dkw)), variables(tdetr),
             j_assoc.Associator(j_assoc.AssociatorConfig(**akw)), variables(tassoc)),
            (tdetr, tassoc), pkw)


def _tiny_scenes(lengths):
    K = np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(5)
    return [{"frames": [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)],
             "frame_ids": [10 * s + f for f in range(n)],
             "T_wcs": [_pose(f + 2 * s) for f in range(n)],
             "K": K * np.array([[1 + 0.1 * s], [1 + 0.1 * s], [1]], np.float32)}
            for s, n in enumerate(lengths)]


def test_runner_equals_jax_runner(monkeypatch):
    """The seeded tiny models with the greedy decode in 3 lanes on scenes of
    3 / 5 / 4 frames (64x64), against JAX's runner on a one-device CPU
    mesh, with the mapping
    settings of tests/test_scene_parallel.py (20 Adam iterations).  Tracks
    with frame ids, classes and order exact, rows within 1e-4, bboxes_dl
    within 1e-3, bboxes_qc at IoU >= 0.95 (the Adam solve is chaotic at the
    rounding level), and each lane's overflow report equal."""
    jax_models, (tdetr, tassoc), pkw = _seeded_tiny_models()
    mapping = dict(optim_iters=20, optim_samples=256, min_views=4, max_objs=8, max_views=32)
    scenes = _tiny_scenes((3, 5, 4))

    reports = []

    class RecordingShim(j_sp._FinalizeShim):
        def merge_process(self, data):
            reports.append(self.overflow_report(warn=False))
            return super().merge_process(data)

    monkeypatch.setattr(j_sp, "_FinalizeShim", RecordingShim)
    mesh = j_mesh.make_mesh({"dp": 1}, jax.devices()[:1])
    want = j_sp.SceneParallelRunner(*jax_models, j_proc.PipelineConfig(**pkw, **mapping), mesh,
                                    n_lanes=3).run_scenes(scenes, 64, 64)
    got = t_sp.SceneParallelRunner(tdetr, tassoc, t_proc.PipelineConfig(**pkw, **mapping), 3,
                                   device="cpu").run_scenes(scenes, 64, 64)
    for lane, (g, w) in enumerate(zip(got, want)):
        w = jax.tree.map(np.asarray, w)
        assert sum(len(t) for t in g["tracks"]) >= len(scenes[lane]["frames"]), lane
        _assert_outputs_close(g, w, 1e-4, f"lane {lane}")
        assert g["overflow_report"] == reports[lane], lane


# ----------------------------------------------------------------------- CLI

def test_cli_scene_parallel_equals_serial_cli(tmp_path, monkeypatch, capsys):
    """``run_processor --scene_parallel 2 --device cpu`` on two hard scenes
    (3 frames, 8 objects of 8 views) writes the serial CLI's pickles: frame
    ids, classes and track order exact, rows within 1e-3, bboxes_dl within
    1e-3, bboxes_qc at IoU >= 0.95 (the serial CLI normalizes on the host,
    the lanes on the device).  Both CLIs solve with 10 Adam iterations of
    100 samples (a PipelineConfig default patched for both), to keep the
    test short.  A second run with ``--resume`` skips both scenes; without
    ``--device cpu`` and without a card it raises."""
    monkeypatch.setattr(t_proc, "PipelineConfig",
                        functools.partial(t_proc.PipelineConfig, optim_iters=10,
                                          optim_samples=100))
    split = str(tmp_path / "split.txt")
    with open(split, "w") as f:
        f.write("\n".join(HARD_SCENES[:2]) + "\n")
    flags = ["--config_path", os.path.join(HARD, "rehearsal.yaml"),
             "--scans_root", os.path.join(HARD, "scans"), "--sequences", split,
             "--short_side", "192", "--max_size", "192", "--max_frames", "3",
             "--max_objs", "8", "--max_views", "8", "--min_views", "2", "--dtype", "float32",
             "--detector_ckpt", os.path.join(ART, "rehearsal_hard_detr.npz"),
             "--associator_ckpt", os.path.join(ART, "rehearsal_hard_assoc.npz")]
    serial, lanes = str(tmp_path / "serial"), str(tmp_path / "lanes")
    assert t_run.main(flags + ["--device", "cpu", "--out_dir", serial]) == 0
    assert t_run.main(flags + ["--device", "cpu", "--out_dir", lanes,
                               "--scene_parallel", "2"]) == 0
    out = capsys.readouterr().out
    assert "group of 2 scenes: 6 frames in" in out and "fps aggregate" in out
    for seq_id in HARD_SCENES[:2]:
        with open(os.path.join(serial, seq_id, seq_id), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(lanes, seq_id, seq_id), "rb") as f:
            got = pickle.load(f)
        assert set(got) == {"tracks", "bboxes_qc", "bboxes_dl", "quadrics"}
        assert f"  {seq_id}: {len(got['tracks'])} tracks" in out
        _assert_outputs_close(got, want, 1e-3, seq_id)
    assert t_run.main(flags + ["--device", "cpu", "--out_dir", lanes, "--scene_parallel", "2",
                               "--resume"]) == 0
    out = capsys.readouterr().out
    assert all(f"skipping (resume): {s}" in out for s in HARD_SCENES[:2])
    assert "group of" not in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_run.main(flags + ["--out_dir", lanes, "--scene_parallel", "2"])
