"""The heuristic-tracker baseline and the mapping CLIs of the port against
the JAX package's, on the CPU.

- ``HeuristicTracker``: the cases of ``tests/test_aux.py`` and a seeded
  20-frame stream with depth, run through both packages: track rows equal
  and ``inactive`` sets identical.  The stream shows the reference's
  point-match quirk (no ``K`` in ``_match_by_points``), which both copy.
- ``run_tracking`` on the committed scene9700_00 with the committed
  rehearsal detector, 4 frames at 800x800, float32 in both, in one process:
  the same tracks in the same order, frame and class exact, the other
  columns within 1e-3, the box columns in units of the frame.  In pixels
  they are up to 0.033 px apart (4.1e-5 of the 800-px frame) with torch
  on one thread: torch's CPU GroupNorm gives other values on one thread
  (groups of 640,000 values here), which moves DETR's boxes by 3e-5 of
  the frame; with 8 threads they are 0.0004-0.0007 px from JAX's.
- ``run_multi_view`` (``--n_iters 5``: the Adam solve is chaotic over 200,
  ``tests/test_torch_cli.py``) then ``run_merge`` on one tracks pickle:
  ``bboxes_dl`` within 1e-3, ``bboxes_qc`` at oriented IoU >= 0.95, the
  merged tracks equal.

JAX's side runs its own CLI ``main`` with its model built by the test:
float32, the committed ``.npz`` tree (its orbax checkpoint bit for bit,
without orbax's restore) and the forward and postprocess jitted, which the
CLI runs op by op (about 50 s more on this CPU, the same function).
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from odam_torch.models.convert import load_flax_npz
from odam_torch.runtime import heuristic_tracker as t_ht
from odam_torch.scripts import run_merge as t_merge
from odam_torch.scripts import run_multi_view as t_mv
from odam_torch.scripts import run_processor as t_rp
from odam_torch.scripts import run_tracking as t_rt
from odam_torch.utils.host_boxes import robust_box3d_iou
from odam_tpu.runtime import heuristic_tracker as j_ht
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HARD = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard")
SCENE = "scene9700_00"
# The committed rehearsal detector as a Flax tree, bit for bit its orbax
# checkpoint (tests/test_torch_checkpoints.py), read by both packages.
DETR_NPZ = os.path.join(ROOT, "artifacts", "torch", "rehearsal_hard_detr.npz")


# ------------------------------------------------------------------ tracker

def _det(cls, box, t_co, score=0.9, dims=(1.0, 1.0, 1.0)):
    return {"cls": cls, "box": np.asarray(box, float), "dims": np.asarray(dims),
            "t_co": np.asarray(t_co, float), "score": score}


def _continuity(mod):
    tr = mod.HeuristicTracker()
    for f in range(5):
        tr.step([_det(3, [100 + 2 * f, 100, 200 + 2 * f, 200], [0.05 * f, 0, 2])], f, np.eye(4))
    assert len(tr.export_tracks()) == 1 and len(tr.export_tracks()[0]) == 5
    return tr


def _class_gate(mod):
    tr = mod.HeuristicTracker()
    tr.step([_det(3, [100, 100, 200, 200], [0, 0, 2])], 0, np.eye(4))
    tr.step([_det(4, [100, 100, 200, 200], [0, 0, 2])], 1, np.eye(4))
    assert len(tr.export_tracks()) == 2
    return tr


def _gap_fallback(mod):
    tr = mod.HeuristicTracker(max_gap=5)
    tr.step([_det(3, [100, 100, 200, 200], [0, 0, 2])], 0, np.eye(4))
    tr.step([], 7, np.eye(4))
    assert 0 in tr.inactive
    tr.step([_det(3, [400, 300, 500, 400], [0.05, 0, 2])], 8, np.eye(4))
    tracks = tr.export_tracks()
    assert len(tracks) == 1 and len(tracks[0]) == 2
    return tr


def _depth_points(mod):
    tr = mod.HeuristicTracker()
    img = np.zeros((120, 160, 3), np.uint8)
    depth = np.full((60, 80), 2.0, np.float32)
    K_d = np.array([[50.0, 0, 40], [0, 50, 30], [0, 0, 1]])
    tr.step([_det(3, [40, 30, 120, 90], [0, 0, 2])], 0, np.eye(4), img, depth, K_d)
    assert tr.tracks[0].points is not None and len(tr.tracks[0].points) > 0
    tr.step([_det(3, [42, 32, 122, 92], [0, 0, 2])], 1, np.eye(4), img, depth, K_d)
    assert len(tr.export_tracks()) == 1 and len(tr.tracks[0].rows) == 2
    return tr


def _stream(mod, seed: int = 0, n_frames: int = 20):
    """Three objects over 20 frames (each seen with probability 0.85, boxes
    and centres jittered), depth from a seeded random map, and in some
    frames a small box at the image's top-left corner of object 0's class.
    Object 0 sits right of and below the principal point, so its cloud's
    coordinates divided by depth (no K) lie in (0, 0.8): inside a corner box
    of a few pixels, which the point match then attaches to its track."""
    rng = np.random.default_rng(seed)
    img = np.zeros((120, 160, 3), np.uint8)
    K_d = np.array([[50.0, 0, 40], [0, 50, 30], [0, 0, 1]])
    centres = np.array([[120.0, 90.0], [40.0, 40.0], [60.0, 95.0]])
    sizes = np.array([[30.0, 24.0], [36.0, 30.0], [28.0, 20.0]])
    classes = [2, 5, 2]
    t_cos = rng.uniform(-1, 1, (3, 3)) + np.array([0, 0, 3.0])
    tr = mod.HeuristicTracker()
    for f in range(n_frames):
        dets = []
        for o in range(3):
            if rng.uniform() > 0.85:
                continue
            c = centres[o] + rng.normal(0, 2, 2)
            box = np.concatenate([c - sizes[o] / 2, c + sizes[o] / 2])
            dets.append(_det(classes[o], box, t_cos[o] + rng.normal(0, 0.02, 3),
                             float(rng.uniform(0.5, 1.0)), dims=rng.uniform(0.4, 0.6, 3)))
        if rng.uniform() < 0.3:
            dets.append(_det(classes[0], [0.0, 0.0, *rng.uniform(2, 6, 2)],
                             rng.uniform(5, 6, 3), 0.9))
        depth = rng.uniform(1.5, 2.5, (60, 80)).astype(np.float32)
        tr.step(dets, f, np.eye(4), img, depth, K_d)
    return tr


CASES = {"continuity": _continuity, "class_gate": _class_gate, "gap_fallback": _gap_fallback,
         "depth_points": _depth_points, "random_stream": _stream}


@pytest.mark.parametrize("case", sorted(CASES))
def test_heuristic_tracker_matches_jax(case):
    got, want = CASES[case](t_ht), CASES[case](j_ht)
    a, b = got.export_tracks(), want.export_tracks()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert got.inactive == want.inactive
    for p, q in zip(got.tracks, want.tracks):
        assert (p.points is None) == (q.points is None)
        if p.points is not None:
            np.testing.assert_array_equal(p.points, q.points)


def test_point_match_quirk_is_visible_in_the_stream():
    """The corner boxes join object 0's track by the point match alone
    (IoU 0 with every track, 3D IoU 0 at their far centres), and a
    detection whose box holds the cloud's pixel projection does not."""
    tracks = _stream(t_ht).export_tracks()
    corner = [t for t in tracks if (t[:, 2] == 0).any()]
    joined = [t for t in corner if (t[:, 2] != 0).any()]
    assert joined, "no corner box was attached by the point match"

    tr = t_ht.HeuristicTracker(iou2d_threshold=2.0, iou3d_threshold=2.0)   # IoU never matches
    img = np.zeros((120, 160, 3), np.uint8)
    depth = np.full((60, 80), 2.0, np.float32)
    K_d = np.array([[50.0, 0, 40], [0, 50, 30], [0, 0, 1]])
    tr.step([_det(3, [90, 70, 150, 110], [0, 0, 2])], 0, np.eye(4), img, depth, K_d)
    tr.step([_det(3, [90, 70, 150, 110], [0, 0, 2])], 1, np.eye(4), img, depth, K_d)
    assert len(tr.export_tracks()) == 2      # the same box in pixels: no point match


def test_detect_keypoints_grid_matches_jax():
    img = np.zeros((64, 64, 3), np.uint8)
    np.testing.assert_array_equal(t_ht.detect_keypoints(img), j_ht.detect_keypoints(img))
    assert len(t_ht.detect_keypoints(img)) > 0


# ------------------------------------------------------------- run_tracking

def _jax_build_models(cfg, detector_ckpt, associator_ckpt, dtype_name="bfloat16", **kw):
    """JAX's detector in float32 with a jitted forward, its weights the Flax
    tree of ``detector_ckpt`` (.npz): the stand-in for
    ``scripts.run_processor.build_models``."""
    import jax
    import jax.numpy as jnp

    from odam_tpu.models import detr as detr_mod

    detr = detr_mod.DETR(detr_mod.DETRConfig.from_cfg(cfg, dtype=jnp.float32, use_pallas=False))

    class Jitted:
        apply = staticmethod(jax.jit(detr.apply))

    return Jitted, load_flax_npz(detector_ckpt), None, None


@pytest.fixture(scope="module")
def tracking(tmp_path_factory):
    """Both packages' run_tracking on scene9700_00, 4 frames at 800x800."""
    import jax

    import odam_tpu.models.detr as j_detr
    import odam_tpu.utils.compile_cache as j_cache
    import scripts.run_processor as j_rp
    import scripts.run_tracking as j_rt

    tmp = tmp_path_factory.mktemp("tracking")
    split = tmp / "split.txt"
    split.write_text(SCENE + "\n")
    common = ["--config_path", os.path.join(HARD, "rehearsal.yaml"),
              "--scans_root", os.path.join(HARD, "scans"), "--sequences", str(split),
              "--max_frames", "4"]
    t_build = t_rp.build_models
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_cache, "enable", lambda *a, **k: None)
        mp.setattr(j_rp, "build_models", _jax_build_models)
        mp.setattr(j_detr, "postprocess", jax.jit(j_detr.postprocess))
        mp.setattr(sys, "argv", ["run_tracking.py", *common, "--out_dir", str(tmp / "jax"),
                                 "--detector_ckpt", DETR_NPZ])
        j_rt.main()
        mp.setattr(t_rp, "build_models", lambda cfg, d, a, decode, device, dtype, **kw:
                   t_build(cfg, d, a, decode, device, torch.float32, **kw))
        assert t_rt.main([*common, "--out_dir", str(tmp / "torch"), "--device", "cpu",
                          "--detector_ckpt", DETR_NPZ]) == 0

    def load(d):
        with open(tmp / d / SCENE / SCENE, "rb") as f:
            return pickle.load(f)

    return {"tmp": tmp, "jax": load("jax"), "torch": load("torch"),
            "pickle": str(tmp / "jax" / SCENE / SCENE)}


def test_run_tracking_matches_jax(tracking):
    t, j = tracking["torch"], tracking["jax"]
    assert set(t) == {"tracks"}
    assert len(t["tracks"]) == len(j["tracks"]) >= 5
    frame = 800.0                       # 192x192 frames resized to 800x800
    for k, (a, b) in enumerate(zip(t["tracks"], j["tracks"])):
        assert a.shape == b.shape and a.shape[1] == 14, k
        np.testing.assert_array_equal(a[:, :2], b[:, :2], err_msg=f"track {k}")
        np.testing.assert_allclose(a[:, 2:6] / frame, b[:, 2:6] / frame, atol=1e-3, rtol=0,
                                   err_msg=f"track {k} boxes")
        np.testing.assert_allclose(a[:, 6:], b[:, 6:], atol=1e-3, rtol=0, err_msg=f"track {k}")
    print(f"\nbox columns port vs JAX: max {max(np.abs(a[:, 2:6] - b[:, 2:6]).max() for a, b in zip(t['tracks'], j['tracks'])):.4f} px")


def test_run_multi_view_then_merge_match_jax(tracking):
    import scripts.run_merge as j_merge
    import scripts.run_multi_view as j_mv

    import odam_tpu.utils.compile_cache as j_cache

    tmp = tracking["tmp"]
    common = ["--tracks", tracking["pickle"], "--scans_root", os.path.join(HARD, "scans"),
              "--scene", SCENE, "--n_iters", "5", "--min_views", "2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_cache, "enable", lambda *a, **k: None)
        mp.setattr(sys, "argv", ["run_multi_view.py", *common, "--out", str(tmp / "j_mv.pkl")])
        j_mv.main()
        mp.setattr(sys, "argv", ["run_merge.py", "--input", str(tmp / "j_mv.pkl"),
                                 "--out", str(tmp / "j_merge.pkl")])
        j_merge.main()
    t = t_mv.main([*common, "--out", str(tmp / "t_mv.pkl"), "--device", "cpu"])
    merged = t_merge.main(["--input", str(tmp / "t_mv.pkl"), "--out", str(tmp / "t_merge.pkl")])
    with open(tmp / "j_mv.pkl", "rb") as f:
        j = pickle.load(f)
    with open(tmp / "t_mv.pkl", "rb") as f:
        written = pickle.load(f)
    assert set(written) == {"tracks", "bboxes_qc", "bboxes_dl", "quadrics"}
    assert len(t["bboxes_qc"]) == len(j["bboxes_qc"]) == len(tracking["jax"]["tracks"])
    for a, b in zip(t["bboxes_dl"], j["bboxes_dl"]):
        np.testing.assert_allclose(a, b, atol=1e-3)
    ious = [robust_box3d_iou(a, b) for a, b in zip(t["bboxes_qc"], j["bboxes_qc"])]
    assert min(ious) >= 0.95, ious
    assert type(written["quadrics"]).__name__ == "SQParams"
    for a, b in zip(written["quadrics"], j["quadrics"]):
        assert isinstance(a, np.ndarray) and a.shape == np.asarray(b).shape
    with open(tmp / "j_merge.pkl", "rb") as f:
        j_merged = pickle.load(f)["tracks"]
    assert len(merged) == len(j_merged) < len(t["tracks"])
    for a, b in zip(merged, j_merged):
        np.testing.assert_array_equal(a, b)
