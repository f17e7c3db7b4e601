"""The port's evaluation and host tooling against the JAX package's, on the
CPU: the offline associator evaluation (``evaluate_scene`` and the
``eval_association`` CLI), ``prior_calculation``, the detection metrics,
the ground-truth readers, ``StageTimer`` / ``topk_accuracy`` /
``profiler_trace``, the config helpers, the file helpers, the geometry
helpers and the superquadric mesh export.

Tolerances: integers and per-frame counts exact, P / R / F1 equal, tables
and reader arrays equal, geometry within 1e-5, mesh vertices within 1e-5.
The exported OBJ's face lines are equal and its vertex lines agree to one
unit of their sixth decimal: XLA's and torch's cos, sin and pow differ by
an ulp (1.2e-7), which the six-decimal text rounds either way.
"""
import json
import os
import pickle
import struct
import sys

import numpy as np
import pytest
import torch

from odam_torch import config as t_config
from odam_torch.data import scannet as t_scannet
from odam_torch.eval import association as t_assoc
from odam_torch.eval import detection as t_det
from odam_torch.mapping import superquadric as t_sq
from odam_torch.scripts import eval_association as t_eval_assoc
from odam_torch.scripts import prior_calculation as t_prior_calc
from odam_torch.scripts import result_viewer as t_viewer
from odam_torch.scripts.train_associator import synthetic_scenes
from odam_torch.utils import files as t_files
from odam_torch.utils import geometry as t_geo
from odam_torch.utils import metrics as t_metrics
from odam_torch.utils import visualization as t_viz
from odam_tpu import config as j_config
from odam_tpu.data import scannet as j_scannet
from odam_tpu.eval import detection as j_det
from odam_tpu.utils import files as j_files
from odam_tpu.utils import metrics as j_metrics
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HARD = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard")
# The committed rehearsal associator as a Flax tree, bit for bit its orbax
# checkpoint (tests/test_torch_checkpoints.py), read by both packages.
ASSOC_NPZ = os.path.join(ROOT, "artifacts", "torch", "rehearsal_hard_assoc.npz")


# -------------------------------------------------------- association eval

@pytest.fixture(scope="module")
def track_pickles(tmp_path_factory):
    """Two synthetic scenes x 6 tracks x 40 frames from one seed, the port's
    generator checked equal to JAX's, written as the CLI reads them."""
    from scripts.train_associator import synthetic_scenes as j_synthetic

    scenes = synthetic_scenes(np.random.default_rng(4), n_scenes=2)
    for name, tracks in j_synthetic(np.random.default_rng(4), n_scenes=2).items():
        assert len(tracks) == len(scenes[name]) == 6
        for a, b in zip(scenes[name], tracks):
            np.testing.assert_array_equal(a, b)
    d = tmp_path_factory.mktemp("assoc_tracks")
    for name, tracks in scenes.items():
        with open(d / name, "wb") as f:
            pickle.dump({"tracks": tracks}, f)
    return d, scenes


def test_eval_association_matches_jax(track_pickles, capsys):
    """The port's CLI with the committed rehearsal associator against JAX's
    ``evaluate_scene`` with the same weights, at --max_tracks 64 --max_dets
    30 --window 100: per-frame tuples exact, P / R / F1 and the printed
    report equal.  JAX's apply is jitted (its CLI runs it op by op: about
    40 s more here, the same function)."""
    import jax

    from odam_torch.models.convert import load_flax_npz
    from odam_tpu.eval import association as j_assoc
    from odam_tpu.models import associator as j_am

    d, scenes = track_pickles
    cfg_path = os.path.join(HARD, "rehearsal.yaml")
    model = j_am.Associator(j_am.AssociatorConfig.from_cfg(j_config.merge_cfg([cfg_path])))
    params = load_flax_npz(ASSOC_NPZ)

    class Jitted:
        apply = staticmethod(jax.jit(model.apply))

    want = {name: j_assoc.evaluate_scene(Jitted, params, scenes[name], 0.1, 64, 30, 100)
            for name in sorted(scenes)}
    capsys.readouterr()
    got = t_eval_assoc.main(["--config_path", cfg_path, "--tracks_dir", str(d),
                             "--ckpt", ASSOC_NPZ,
                             "--max_tracks", "64", "--max_dets", "30", "--window", "100",
                             "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    totals = t_assoc.AssociationMetrics()
    lines = []
    for name, w in want.items():
        g = got[name]
        assert g.per_frame == w.per_frame and g.n_frames == w.n_frames > 30
        assert (g.precision, g.recall, g.f1) == (w.precision, w.recall, w.f1)
        assert 0 < w.n_correct < w.n_gt_matched
        lines.append(f"{name}: P {w.precision:.3f} R {w.recall:.3f} F1 {w.f1:.3f} "
                     f"({w.n_frames} frames)")
        totals.n_correct += w.n_correct
        totals.n_pred_matched += w.n_pred_matched
        totals.n_gt_matched += w.n_gt_matched
        totals.n_frames += w.n_frames
    lines.append(f"TOTAL: P {totals.precision:.3f} R {totals.recall:.3f} "
                 f"F1 {totals.f1:.3f} ({totals.n_frames} frames)")
    assert printed[-3:] == lines
    assert (got["TOTAL"].precision, got["TOTAL"].f1) == (totals.precision, totals.f1)


def test_association_eval_perfect_matcher():
    """A model that matches detection d to track d scores P = R = F1 = 1."""

    class Out:
        def __init__(self, matches):
            self.matches = matches

    class Identity(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.anchor = torch.nn.Parameter(torch.zeros(()))

        def forward(self, tracks, track_mask, dets, det_mask, threshold):
            n = dets.shape[1]
            return Out(torch.where(det_mask[0], torch.arange(n), -1)[None])

    tracks = []
    for t in range(3):
        rows = np.full((6, 82), -1.0, np.float32)
        rows[:, 0] = np.arange(6)
        rows[:, 1] = t
        tracks.append(rows)
    m = t_assoc.evaluate_scene(Identity(), tracks, max_tracks=8, max_dets=4)
    assert m.n_frames == 5
    assert m.precision == 1.0 and m.recall == 1.0 and m.f1 == 1.0


def test_eval_association_needs_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="need --ckpt"):
        t_eval_assoc.main(["--tracks_dir", str(tmp_path), "--device", "cpu"])


# -------------------------------------------------------- prior_calculation

def test_prior_calculation_matches_jax(tmp_path, monkeypatch, capsys):
    """The committed rehearsal annotations hold no 'display' model, so both
    packages raise on them (the reference's inverse of an empty covariance;
    ROADMAP.md, Queue 3).  With seeded models added until every class has
    six, both print and write equal tables."""
    import scripts.prior_calculation as j_prior_calc

    from odam_torch.mapping import prior

    ann = os.path.join(HARD, "full_annotations.json")
    for run in (lambda: t_prior_calc.main(["--scan2cad", ann]),
                lambda: (monkeypatch.setattr(sys, "argv", ["prior_calculation.py",
                                                           "--scan2cad", ann]),
                         j_prior_calc.main())):
        with pytest.raises(np.linalg.LinAlgError):
            run()
    rng = np.random.default_rng(5)
    with open(ann) as f:
        scans = json.load(f)
    for cat in prior.CLASS_NAMES:
        scans[0]["aligned_models"] += [
            {"catid_cad": cat, "id_cad": f"seeded{i}",
             "trs": {"translation": [0.0, 0.0, 0.0], "rotation": [1.0, 0.0, 0.0, 0.0],
                     "scale": rng.uniform(0.5, 1.5, 3).tolist()},
             "bbox": rng.uniform(0.2, 1.0, 3).tolist()} for i in range(6)]
    ann = str(tmp_path / "annotations.json")
    with open(ann, "w") as f:
        json.dump(scans, f)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["prior_calculation.py", "--scan2cad", ann,
                                      "--out", str(tmp_path / "jax.pkl")])
    j_prior_calc.main()
    j_text = capsys.readouterr().out
    got = t_prior_calc.main(["--scan2cad", ann, "--out", str(tmp_path / "torch.pkl")])
    assert capsys.readouterr().out == j_text
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "torch.pkl", "rb") as f:
        written = pickle.load(f)
    assert list(got) == list(want) == list(written) == list(prior.CLASS_NAMES)
    for cat in want:
        assert np.isfinite(want[cat]).all()
        np.testing.assert_array_equal(got[cat], want[cat])
        np.testing.assert_array_equal(written[cat], want[cat])


# ------------------------------------------------------- detection metrics

def _det_case(seed: int = 0):
    rng = np.random.default_rng(seed)
    preds, gts = {}, {}
    for s in range(3):
        scene = f"s{s}"
        preds[scene], gts[scene] = [], []
        for cls in range(4):
            for _ in range(3):
                lo = rng.uniform(0, 5, 3)
                box = np.stack([lo, lo + rng.uniform(0.5, 2, 3)])
                gts[scene].append((cls, box))
                preds[scene].append((cls, box + rng.uniform(-0.3, 0.3, 3),
                                     float(rng.uniform(0.1, 1))))
    return preds, gts


def test_voc_ap_and_simple_eval_det_match_jax():
    r, p = np.array([0.5, 1.0]), np.array([1.0, 1.0])
    rng = np.random.default_rng(1)
    rr, pp = np.sort(rng.uniform(size=20)), rng.uniform(size=20)
    for use_07 in (False, True):
        for args in ((r, p), (np.array([0.0]), np.array([0.0])), (rr, pp)):
            assert t_det.voc_ap(*args, use_07) == j_det.voc_ap(*args, use_07)
    assert t_det.voc_ap(r, p) == pytest.approx(1.0)
    box = np.array([[0, 0, 0], [1, 1, 1.0]])
    far = box + 10
    preds = {"s1": [(0, box, 0.9), (0, far + 5, 0.8)]}
    gts = {"s1": [(0, box), (0, far)]}
    out = t_det.eval_det(preds, gts)
    assert out == j_det.eval_det(preds, gts)
    assert out[0]["recall"] == pytest.approx(0.5) and out[0]["precision"] == pytest.approx(0.5)


def test_eval_det_pool_matches_serial_and_jax(monkeypatch):
    """The spawned pool (n_workers 2, cpu_count faked up as in
    tests/test_config_data_eval.py) equals the serial path and JAX's."""
    preds, gts = _det_case()
    serial = t_det.eval_det(preds, gts)
    assert serial == j_det.eval_det(preds, gts)
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    pooled = t_det.eval_det(preds, gts, n_workers=2)
    assert pooled == serial == j_det.eval_det(preds, gts, n_workers=2)
    assert len(serial) == 4 and all(0 < v["ap"] <= 1 for v in serial.values())


def test_alignment_accuracy_matches_jax():
    R, t, s = np.eye(3), np.zeros(3), np.ones(3)
    c, si = np.cos(np.pi), np.sin(np.pi)
    R180 = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1]])
    cases = [((t, R, s, t, R, s), {}, True), ((t + 0.5, R, s, t, R, s), {}, False),
             ((t, R180, s, t, R, s), {"n_rot_sym": 1}, False),
             ((t, R180, s, t, R, s), {"n_rot_sym": 2}, True),
             ((t + 9, R, s, t, R, s), {"iou": 0.6}, True),
             ((t, R, s * 1.3, t, R, s), {}, False)]
    for args, kw, want in cases:
        assert t_det.alignment_accuracy(*args, **kw) is j_det.alignment_accuracy(*args, **kw)
        assert t_det.alignment_accuracy(*args, **kw) == want


# ---------------------------------------------------------------- readers

def _write_ascii_ply(path, verts):
    with open(path, "wb") as f:
        f.write(b"ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"end_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n".encode())


def _write_binary_ply(path, verts, colors):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(b"end_header\n")
        for v, c in zip(verts, colors):
            f.write(struct.pack("<fffBBB", *v, *c))


def test_ply_readers_match_jax(tmp_path, rng):
    verts = rng.normal(size=(10, 3)).astype(np.float32)
    _write_ascii_ply(tmp_path / "a.ply", verts)
    got = t_scannet.read_ply_vertices(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(got, j_scannet.read_ply_vertices(str(tmp_path / "a.ply")))
    np.testing.assert_allclose(got, verts, atol=1e-4)
    colors = rng.integers(0, 255, (7, 3)).astype(np.uint8)
    _write_binary_ply(tmp_path / "b.ply", verts[:7], colors)
    got = t_scannet.read_ply_vertices(str(tmp_path / "b.ply"), with_rgb=True)
    np.testing.assert_array_equal(
        got, j_scannet.read_ply_vertices(str(tmp_path / "b.ply"), with_rgb=True))
    assert got.shape == (7, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 3:], colors)


def test_segmentation_and_annotation_readers_match_jax(tmp_path, rng):
    seg, agg = tmp_path / "seg.json", tmp_path / "agg.json"
    seg.write_text(json.dumps({"segIndices": [0, 0, 1, 2, 2, 2, 3]}))
    agg.write_text(json.dumps({"segGroups": [
        {"objectId": 0, "label": "chair", "segments": [0, 1]},
        {"objectId": 1, "label": "table", "segments": [2]},
        {"objectId": 2, "label": "chair", "segments": [9]}]}))
    inst = t_scannet.read_instance_vertices(str(seg), str(agg))
    np.testing.assert_array_equal(inst, [1, 1, 1, 2, 2, 2, 0])
    np.testing.assert_array_equal(inst, j_scannet.read_instance_vertices(str(seg), str(agg)))
    assert inst.dtype == np.uint32
    assert t_scannet.read_aggregation(str(agg)) == j_scannet.read_aggregation(str(agg))
    assert t_scannet.read_segmentation(str(seg)) == j_scannet.read_segmentation(str(seg))

    ann = tmp_path / "gt.json"
    ann.write_text(json.dumps([[c, rng.normal(size=(8, 3)).tolist()] for c in (1, 5, 10)]))
    got, want = t_scannet.read_gt_annotations(str(ann)), j_scannet.read_gt_annotations(str(ann))
    assert [g[0] for g in got] == [w[0] for w in want] == [1, 5, 10]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])
    pc = rng.normal(size=(5, 3))
    np.testing.assert_array_equal(t_scannet.flip_axis(pc), j_scannet.flip_axis(pc))
    np.testing.assert_array_equal(t_scannet.OBJ_CLASS_IDS, j_scannet.OBJ_CLASS_IDS)
    assert t_scannet.SEMANTIC2NAME == j_scannet.SEMANTIC2NAME


# ------------------------------------------------------ metrics and config

def test_stage_timer_topk_and_profiler_trace(tmp_path, rng):
    st = t_metrics.StageTimer()
    for _ in range(2):
        with st.time("a"):
            pass
    with st.time("b"):
        pass
    s = st.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    js = j_metrics.StageTimer()
    with js.time("a"):
        pass
    assert set(s["a"]) == set(js.summary()["a"]) == {"total_s", "count", "mean_ms"}

    logits = rng.normal(size=(50, 18)).astype(np.float32)
    targets = rng.integers(0, 18, 50)
    got = t_metrics.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(targets), (1, 3, 5))
    assert got == j_metrics.topk_accuracy(logits, targets, (1, 3, 5))
    assert got[0] <= got[1] <= got[2]

    with t_metrics.profiler_trace(None):
        pass
    with t_metrics.profiler_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    written = os.listdir(tmp_path / "trace")
    assert len(written) == 1 and written[0].endswith(".json")
    with open(tmp_path / "trace" / written[0]) as f:
        assert json.load(f)["traceEvents"]


def test_merge_args_save_cfg_and_config_loader_match_jax(tmp_path):
    p1, p2 = tmp_path / "a.yaml", tmp_path / "b.yaml"
    p1.write_text("lr: 0.1\nmodel:\n  depth: 6\n  name: r50\nflag: false\n")
    p2.write_text("model:\n  depth: 12\n")
    opts = ["lr:0.5", "model.depth:3", "flag:true", "extra.k:v"]
    got = t_config.merge_args(t_config.merge_cfg([str(p1), str(p2)]), opts)
    want = j_config.merge_args(j_config.merge_cfg([str(p1), str(p2)]), opts)
    assert got == want and got.model.depth == 3 and got.flag is True and got.lr == 0.5
    t_config.save_cfg(got, str(tmp_path / "t.yaml"))
    j_config.save_cfg(want, str(tmp_path / "j.yaml"))
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert t_config.merge_cfg([str(tmp_path / "t.yaml")]) == got
    loader, j_loader = t_config.ConfigLoader(), j_config.ConfigLoader()
    assert loader.merge_args(loader.merge_cfg([str(p1)]), opts[:1]) == \
        j_loader.merge_args(j_loader.merge_cfg([str(p1)]), opts[:1])
    loader.save_cfg([str(p1), str(p2)], str(tmp_path / "tl.yaml"))
    j_loader.save_cfg([str(p1), str(p2)], str(tmp_path / "jl.yaml"))
    assert (tmp_path / "tl.yaml").read_text() == (tmp_path / "jl.yaml").read_text()


def test_file_helpers_match_jax(tmp_path):
    assert t_files.get_file_name("/a/b/c.txt") == j_files.get_file_name("/a/b/c.txt") == "c"
    stamp = t_files.get_date_time()
    assert len(stamp) == 19 and stamp[4] == "-" and stamp[10] == "_"
    sha = t_files.get_git_sha(ROOT)
    assert sha == j_files.get_git_sha(ROOT)
    assert sha == "unknown" or len(sha) >= 40
    assert t_files.get_git_sha(str(tmp_path)) == "unknown"
    t_files.snapshot_run(str(tmp_path / "t"), cfg={"lr": 0.1, "m": {"d": 2}}, args={"x": 1})
    j_files.snapshot_run(str(tmp_path / "j"), cfg={"lr": 0.1, "m": {"d": 2}}, args={"x": 1})
    assert ((tmp_path / "t" / "config_snapshot.yaml").read_text()
            == (tmp_path / "j" / "config_snapshot.yaml").read_text())
    info = (tmp_path / "t" / "run_info.txt").read_text().splitlines()
    assert info[1:] == (tmp_path / "j" / "run_info.txt").read_text().splitlines()[1:]
    assert info[0].startswith("time: ")


# ---------------------------------------------------------------- geometry

def test_geometry_helpers_match_jax(rng):
    import jax
    import jax.numpy as jnp

    from odam_tpu.utils import geometry as j_geo

    j_project, j_unproject, j_mean, j_normalize = (
        jax.jit(f) for f in (j_geo.project, j_geo.unproject, j_geo.mean_rotation_z,
                             j_geo.normalize_plane))
    pts = rng.normal(size=(2, 7, 3)).astype(np.float32)
    pts[0, 0, 2] = 0.0                       # the eps guard of a zero depth
    pts[0, 1, 2] = 1e-8
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    got = t_geo.project(torch.from_numpy(pts), torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_project(jnp.asarray(pts), jnp.asarray(K))),
                               rtol=1e-5)
    pix = rng.uniform(0, 600, (2, 7, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 5, (2, 7)).astype(np.float32)
    np.testing.assert_allclose(
        t_geo.unproject(torch.from_numpy(pix), torch.from_numpy(depth), torch.from_numpy(K)),
        np.asarray(j_unproject(jnp.asarray(pix), jnp.asarray(depth), jnp.asarray(K))),
        rtol=1e-5, atol=1e-6)
    angles = rng.uniform(-np.pi, np.pi, (3, 9)).astype(np.float32)
    w = rng.uniform(0, 1, (3, 9)).astype(np.float32)
    for weights in (None, w):
        np.testing.assert_allclose(
            t_geo.mean_rotation_z(torch.from_numpy(angles),
                                  None if weights is None else torch.from_numpy(weights)),
            np.asarray(j_mean(jnp.asarray(angles),
                              None if weights is None else jnp.asarray(weights))),
            atol=1e-5)
    planes = rng.normal(size=(4, 4)).astype(np.float32)
    planes[0, :3] = 0.0
    np.testing.assert_allclose(t_geo.normalize_plane(torch.from_numpy(planes)),
                               np.asarray(j_normalize(jnp.asarray(planes))),
                               rtol=1e-6)


# ------------------------------------------------------------------ meshes

def _quadrics(rng, n: int = 3):
    return [t_sq.SQParams(translate=rng.normal(size=3).astype(np.float32),
                          angle=np.asarray(rng.uniform(-3, 3), np.float32),
                          scales=rng.uniform(0.3, 1.2, 3).astype(np.float32),
                          shapes=rng.normal(size=2).astype(np.float32)) for _ in range(n)]


def _same_obj(got: str, want: str) -> None:
    """Face lines equal, vertex lines within one unit of the sixth decimal."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) and sum(line.startswith("v ") for line in g) > 0
    assert [line for line in g if line.startswith("f ")] == \
        [line for line in w if line.startswith("f ")]
    gv = np.array([line.split()[1:] for line in g if line.startswith("v ")], float)
    wv = np.array([line.split()[1:] for line in w if line.startswith("v ")], float)
    np.testing.assert_allclose(gv, wv, atol=1.5e-6, rtol=0)


def test_sq_surface_mesh_and_obj_match_jax(tmp_path, rng):
    from odam_tpu.mapping import superquadric as j_sq
    from odam_tpu.utils import visualization as j_viz

    quadrics = _quadrics(rng)
    for q in quadrics:
        v, f = t_viz.sq_surface_mesh(q, grid=12)
        jv, jf = j_viz.sq_surface_mesh(j_sq.SQParams(*q), grid=12)
        np.testing.assert_allclose(v, jv, atol=1e-5)
        np.testing.assert_array_equal(f, jf)
        assert f.max() < len(v)
    tv, _ = t_viz.sq_surface_mesh(t_sq.SQParams(*[torch.from_numpy(np.asarray(x))
                                                  for x in quadrics[0]]), grid=12)
    np.testing.assert_array_equal(tv, t_viz.sq_surface_mesh(quadrics[0], grid=12)[0])
    t_viz.export_scene_obj(str(tmp_path / "t.obj"), quadrics, grid=12)
    j_viz.export_scene_obj(str(tmp_path / "j.obj"), [j_sq.SQParams(*q) for q in quadrics],
                           grid=12)
    _same_obj((tmp_path / "t.obj").read_text(), (tmp_path / "j.obj").read_text())


def test_result_viewer_matches_jax(tmp_path, rng, monkeypatch):
    import scripts.result_viewer as j_viewer

    with open(tmp_path / "result", "wb") as f:
        pickle.dump({"quadrics": [*_quadrics(rng, 2), None]}, f)
    t_viewer.main(["--input", str(tmp_path / "result"), "--obj_out", str(tmp_path / "t.obj"),
                   "--grid", "12"])
    monkeypatch.setattr(sys, "argv", ["result_viewer.py", "--input", str(tmp_path / "result"),
                                      "--obj_out", str(tmp_path / "j.obj"), "--grid", "12"])
    j_viewer.main()
    _same_obj((tmp_path / "t.obj").read_text(), (tmp_path / "j.obj").read_text())


def test_matplotlib_snapshots(tmp_path):
    pytest.importorskip("matplotlib")
    t_viz.save_detection_snapshot(str(tmp_path / "d.png"), np.zeros((64, 64, 3), np.uint8),
                                  np.array([[5, 5, 30, 30]]), labels=["chair"], scores=[0.9])
    t_viz.save_matching_snapshot(str(tmp_path / "m.png"), np.zeros((64, 64, 3), np.uint8),
                                 np.array([[5, 5, 30, 30]]),
                                 np.array([[6, 6, 31, 31], [40, 40, 60, 60]]), np.array([0, -1]))
    t_viz.plot_loss(str(tmp_path / "l.png"), [3.0, 2.0, 1.5])
    assert all(os.path.getsize(tmp_path / n) > 0 for n in ("d.png", "m.png", "l.png"))
