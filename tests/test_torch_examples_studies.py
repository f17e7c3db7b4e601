"""The rehearsal studies of ``odam_torch.examples.cli_rehearsal`` against
the JAX package's ``examples/cli_rehearsal`` on the CPU.

The fixture writes a three-scene, 8-frame hard split with the port's
``make_dataset``, runs one real cell of the port's CLI (``run_processor``
in-process, scene 0 only) and adds synthetic result pickles for scenes 1
and 2 (the ground truth with chosen faults: short tracks, shifted boxes, a
wrong class, a missing track; scene 2 without ``bboxes_dl``).  On these:

- ``ci_eval.scene_table``, ``bootstrap_ci`` and ``paired_delta`` (1000
  draws, the same seed) equal JAX's exactly;
- ``tune_min_views.score`` and its sweep equal JAX's exactly;
- ``audit_misses.audit_scene`` gives JAX's rows, modes and blames, floats
  within 1e-6, and its per-row corners are JAX's within 1e-6;
- ``diagnose_recall.oracle_detections`` equals JAX's for the same rng, and
  the ``oracle_det`` stage's tracking on one seed with the committed
  associator (JAX from orbax, the port from ``.npz``) gives JAX's track
  ids and row counts, rows within ORACLE_ROW_ATOL (the stage's solve is
  held by ``tests/test_torch_mapping.py``; at one thread here it would take
  minutes);
- the spawning scripts (``ablate``, ``tune_threshold``, ``ablate_big``,
  ``window_experiment``) with ``subprocess.run`` replaced by a recorder fed
  canned ``eval_scan2cad`` output: every command and environment equals
  JAX's after the stated substitutions (script path -> ``-m`` module,
  ``JAX_PLATFORMS`` -> ``--device``, the window's ``PYTHONPATH`` without
  the examples folder), and the tables and JSON they write equal JAX's;
  the window experiment's banked losses are ``[]`` on both sides;
- no default output of the port lies in ``examples/`` or ``artifacts/``.
"""
import argparse
import importlib
import json
import os
import pickle
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jax_examples import ROOT, jax_module
from odam_torch.examples.cli_rehearsal import ablate as t_ablate
from odam_torch.examples.cli_rehearsal import ablate_big as t_big
from odam_torch.examples.cli_rehearsal import audit_misses as t_audit
from odam_torch.examples.cli_rehearsal import ci_eval as t_ci
from odam_torch.examples.cli_rehearsal import common as t_common
from odam_torch.examples.cli_rehearsal import diagnose_recall as t_diag
from odam_torch.examples.cli_rehearsal import hard as t_hard
from odam_torch.examples.cli_rehearsal import make_dataset as t_make
from odam_torch.examples.cli_rehearsal import tune_min_views as t_tmv
from odam_torch.examples.cli_rehearsal import tune_threshold as t_tune
from odam_torch.examples.cli_rehearsal import window_experiment as t_window
from odam_torch.utils import checkpoint as t_ckpt
from torch_threads import one_torch_thread  # noqa: F401

j_ci = jax_module("cli_rehearsal/ci_eval.py")
j_tmv = jax_module("cli_rehearsal/tune_min_views.py")
j_audit = jax_module("cli_rehearsal/audit_misses.py")
j_diag = jax_module("cli_rehearsal/diagnose_recall.py")
j_ablate = jax_module("cli_rehearsal/ablate.py")
j_tune = jax_module("cli_rehearsal/tune_threshold.py")
j_big = jax_module("cli_rehearsal/ablate_big.py")
j_window = jax_module("cli_rehearsal/window_experiment.py")

SEEDS = (0, 1, 2)
N_FRAMES = 8
ORACLE_ROW_ATOL = 1e-5     # f32 rows of the same frames (measured 4.8e-7)
EVAL_OUT = ("class 03211117: precision 0.0000 recall 0.0000 F1 0.0000\n"
            "average: precision 0.5000 recall 0.2500 F1 0.3333\n")
TRAIN_OUT = "1916 association samples\nassociator segment 0: 3 steps in 1s, nll 0.052\n"


# ------------------------------------------------------------------ fixture

def _shifted(corners, dims, yaw, frac):
    """``corners`` moved by ``frac`` of the box's width along its own x."""
    return corners + frac * dims[0] * np.array([np.cos(yaw), np.sin(yaw), 0.0])


def _synthetic_result(seed: int, rng, with_dl: bool) -> dict:
    """A result pickle of scene ``seed``: one track per ground-truth object
    but every seventh, each object given a fault by its index."""
    tracks, qc, dl = [], [], []
    for i, (c, dims, yaw, cls, _) in enumerate(t_hard.make_hard_objects(seed)):
        kind = i % 7
        if kind == 6:                                      # no_track
            continue
        n = 5 if kind == 1 else 12                          # short_track
        rows = np.full((n, 82), -1.0, np.float32)
        rows[:, 0] = np.arange(n)
        rows[:, 1] = (cls + 1) % 8 if kind == 5 else cls     # wrong_class
        rows[:, 6:9] = dims * np.exp(rng.normal(0, 0.02, (n, 3)))
        rows[:, 9:12] = c + rng.normal(0, 0.02, (n, 3))
        rows[:, 12] = yaw + rng.normal(0, 0.02, n)
        gt = t_common.box_corners_np(dims, yaw, c)
        box = gt + rng.normal(0, 0.01, gt.shape)
        dl_box = box
        if kind in (2, 3, 4):                               # bad_box: IoU ~0.18
            box = _shifted(gt, dims, yaw, 0.7)
            if kind in (3, 4):                              # detector / aggregation
                dl_box = _shifted(gt, dims, yaw, 0.8)
                rows[:, 9:12] += 0.8 * dims[0] * np.array([np.cos(yaw), np.sin(yaw), 0.0])
                if kind == 4:
                    rows[0, 9:12] = c
        tracks.append(rows)
        qc.append(box)
        dl.append(dl_box)
    out = {"tracks": tracks, "bboxes_qc": qc}
    if with_dl:
        out["bboxes_dl"] = dl
    return out


def _write(result_dir: str, scene: str, data: dict) -> None:
    os.makedirs(os.path.join(result_dir, scene), exist_ok=True)
    with open(os.path.join(result_dir, scene, scene), "wb") as f:
        pickle.dump(data, f)


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """The split, the real cell (scene 0) and two synthetic cells (a, b)
    holding scene 0's real result and synthetic scenes 1 and 2."""
    from odam_torch.scripts import run_processor

    root = tmp_path_factory.mktemp("studies")
    data = str(root / "data")
    t_make.main_hard(data, seeds=SEEDS, n_frames=N_FRAMES)
    only = root / "scene0.txt"
    only.write_text(t_hard.hard_scene_id(0) + "\n")
    cell = str(root / "cell")
    assert run_processor.main([
        "--config_path", os.path.join(data, "rehearsal.yaml"),
        "--scans_root", os.path.join(data, "scans"), "--sequences", str(only),
        "--detector_ckpt", t_common.DETR_WEIGHTS, "--associator_ckpt", t_common.ASSOC_WEIGHTS,
        "--out_dir", cell, "--offline", "--use_prior", "--short_side", "192",
        "--max_size", "192", "--dtype", "float32", "--max_objs", "16", "--max_views", "8",
        "--device", "cpu"]) == 0
    scene0 = t_hard.hard_scene_id(0)
    with open(os.path.join(cell, scene0, scene0), "rb") as f:
        real = pickle.load(f)
    dirs = {"cell": cell}
    for name, noise_seed in (("synth_a", 1), ("synth_b", 2)):
        dirs[name] = str(root / name)
        rng = np.random.default_rng(noise_seed)
        _write(dirs[name], scene0, real)
        for seed in SEEDS[1:]:
            _write(dirs[name], t_hard.hard_scene_id(seed),
                   _synthetic_result(seed, rng, with_dl=seed == 1))
    return {"root": root, "data": data, "dirs": dirs, "real": real}


# ------------------------------------------------------------------ scoring

def _same_table(t, j):
    assert t["scenes"] == j["scenes"] and len(t["scenes"]) > 0
    np.testing.assert_array_equal(t["counts"], j["counts"])
    assert len(t["obj_ious"]) == len(j["obj_ious"])
    for a, b in zip(t["obj_ious"], j["obj_ious"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cell,min_views", [("cell", 4), ("cell", 10), ("synth_a", 4),
                                            ("synth_b", 10)])
def test_scene_table_equals_jax(studies, cell, min_views):
    d = studies["dirs"][cell]
    _same_table(t_ci.scene_table(d, studies["data"], min_views),
                j_ci.scene_table(d, studies["data"], min_views))


def test_bootstrap_ci_and_paired_delta_equal_jax(studies):
    tables = {k: (t_ci.scene_table(studies["dirs"][k], studies["data"], 4),
                  j_ci.scene_table(studies["dirs"][k], studies["data"], 4))
              for k in ("synth_a", "synth_b")}
    for t, j in tables.values():
        m = t_ci.bootstrap_ci(t, 1000, seed=3)
        assert m == j_ci.bootstrap_ci(j, 1000, seed=3)
        assert t_ci.fmt_cell("a", m) == j_ci.fmt_cell("a", m)
        assert m["n_tp"] > 0 and m["f1_ci"][0] <= m["f1"] <= m["f1_ci"][1]
    (ta, ja), (tb, jb) = tables["synth_a"], tables["synth_b"]
    delta = t_ci.paired_delta(ta, tb, 1000, seed=3)
    assert delta == j_ci.paired_delta(ja, jb, 1000, seed=3)
    assert delta["mean_obj_iou"]["delta"] != 0.0


@pytest.mark.parametrize("min_views", [2, 4, 10])
def test_tune_min_views_score_equals_jax(studies, min_views):
    for d in studies["dirs"].values():
        assert (t_tmv.score(d, studies["data"], min_views)
                == j_tmv.score(d, studies["data"], min_views))


def test_tune_min_views_sweep_equals_jax(studies, tmp_path, capsys):
    argv = ["--data", studies["data"], "--results", os.path.dirname(studies["dirs"]["cell"]),
            "--configs", "cell,synth_a,absent", "--min_views", "2,4,10"]
    t_rows = t_tmv.main(argv + ["--out", str(tmp_path / "t.json")])
    t_out = capsys.readouterr().out
    import sys

    old = sys.argv
    sys.argv = ["tune_min_views.py"] + argv + ["--out", str(tmp_path / "j.json")]
    try:
        j_tmv.main()
    finally:
        sys.argv = old
    assert t_out == capsys.readouterr().out
    assert t_rows == json.loads((tmp_path / "j.json").read_text()) and len(t_rows) == 6


def _same_rows(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float):
                assert abs(a[k] - b[k]) <= 1e-6, (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


@pytest.mark.parametrize("seed,cell,min_views", [(0, "cell", 4), (0, "cell", 10),
                                                 (1, "synth_a", 10), (2, "synth_a", 10),
                                                 (1, "synth_b", 4)])
def test_audit_scene_equals_jax(studies, seed, cell, min_views):
    d = studies["dirs"][cell]
    t_rows, t_fps = t_audit.audit_scene(seed, d, min_views)
    j_rows, j_fps = j_audit.audit_scene(seed, d, min_views)
    _same_rows(t_rows, j_rows)
    assert t_fps == j_fps
    if seed == 1 and min_views == 10:    # the synthetic faults in their modes, every blame
        assert {r["mode"] for r in t_rows} >= {"matched", "short_track", "bad_box",
                                               "wrong_class", "no_track"}
        assert {r.get("blame") for r in t_rows} >= {"mapping", "detector", "aggregation"}


def test_row_corners_equal_jax(studies):
    rows = np.concatenate([np.asarray(t, np.float64) for t in studies["real"]["tracks"]])
    got, want = t_audit._row_corners(rows), j_audit._row_corners(rows)
    assert got.dtype == want.dtype and got.shape == (len(rows), 8, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_audit_main_equals_jax(studies, tmp_path, capsys):
    argv = ["--result_dir", studies["dirs"]["synth_a"], "--seeds", "1,2", "--min_views", "10"]
    t_audit.main(argv + ["--json_out", str(tmp_path / "t.json")])
    t_out = capsys.readouterr().out
    import sys

    old = sys.argv
    sys.argv = ["audit_misses.py"] + argv + ["--json_out", str(tmp_path / "j.json")]
    try:
        j_audit.main()
    finally:
        sys.argv = old
    assert t_out == capsys.readouterr().out and "bad_box blame:" in t_out
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))


# ---------------------------------------------------------------- diagnose

def test_oracle_detections_equal_jax():
    _, flags, _, _ = t_diag.visible_flags(1)
    got = t_diag.oracle_detections(1, flags, 0.02, np.random.default_rng(7001), device="cpu")
    want = j_diag.oracle_detections(1, flags, 0.02, np.random.default_rng(7001))
    assert len(got) == len(want) == t_hard.N_FRAMES_HARD
    for (tf, tT, td), (jf, jT, jd) in zip(got, want):
        assert tf == jf
        np.testing.assert_array_equal(tT, jT)
        for name, a, b in zip(td._fields, td, jd):
            assert a.dtype == getattr(torch, str(np.asarray(b).dtype)), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert sum(int(d.valid.sum()) for _, _, d in got) > 0


def test_oracle_det_tracks_equal_jax():
    seed = 0
    jpipe = j_diag.build_pipeline(os.path.join(ROOT, "artifacts", "rehearsal_hard_assoc_ckpt"),
                                  "exact")
    jpipe.init_sequence(j_diag.hard.K, j_diag.hard.IMG, j_diag.hard.IMG)
    _, flags, _, _ = j_diag.visible_flags(seed)
    for fid, T_wc, dets in j_diag.oracle_detections(seed, flags, 0.02,
                                                    np.random.default_rng(7000 + seed)):
        jpipe.process_detections(dets, fid, T_wc)
    tpipe = t_diag.build_pipeline(t_common.ASSOC_WEIGHTS, "exact", "cpu")
    tpipe.init_sequence(t_hard.K, t_hard.IMG, t_hard.IMG)
    got = t_diag.oracle_tracks(tpipe, seed, 0.02, np.random.default_rng(7000 + seed))
    want = jpipe.tracks
    assert [len(t) for t in got] == [len(t) for t in want] and len(got) >= 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[:, :2], b[:, :2])      # frame ids and classes
        np.testing.assert_allclose(a, b, rtol=0, atol=ORACLE_ROW_ATOL)


# ------------------------------------------------------- spawning scripts

JAX_SCRIPTS = {"scripts/run_processor.py": "odam_torch.scripts.run_processor",
               "scripts/eval_scan2cad.py": "odam_torch.scripts.eval_scan2cad",
               "examples/cli_rehearsal/train.py": "odam_torch.examples.cli_rehearsal.train"}
ON_CARD = {"odam_torch.scripts.run_processor", "odam_torch.examples.cli_rehearsal.train"}


class Recorder:
    """``subprocess.run`` for the scripts: records (command, environment);
    a run_processor call writes ``sources[fault or ""]``'s pickles into its
    ``--out_dir``; eval_scan2cad and the trainer print canned output."""

    def __init__(self, sources: dict):
        self.calls, self.sources = [], sources

    def __call__(self, cmd, cwd=None, env=None, **kwargs):
        self.calls.append((list(cmd), dict(env or {})))
        module = cmd[2] if cmd[1] == "-m" else JAX_SCRIPTS[os.path.relpath(cmd[1], ROOT)]
        if module.endswith("run_processor"):
            src = self.sources[(env or {}).get("ODAM_FAULT_INJECT", "")]
            shutil.copytree(src, cmd[cmd.index("--out_dir") + 1], dirs_exist_ok=True)
        out = TRAIN_OUT if module.endswith("train") else EVAL_OUT
        return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")


def _as_port(cmd: list, env: dict, jax_root: str, port_root: str, drop_path=None):
    """JAX's command and environment after the port's substitutions."""
    exe, script, *rest = cmd
    module = JAX_SCRIPTS[os.path.relpath(script, ROOT)]
    rest = [a.replace(jax_root, port_root) for a in rest]
    if module in ON_CARD:
        rest += ["--device", "cuda"]
    env = dict(env)
    assert env.pop("JAX_PLATFORMS") == "cpu"
    if drop_path:
        env["PYTHONPATH"] = env["PYTHONPATH"].replace(drop_path + ":", "", 1)
    return [exe, "-m", module, *rest], env


def _drive(module, argv, monkeypatch, recorder):
    import sys

    monkeypatch.setattr(subprocess, "run", recorder)
    if module.__name__.startswith("odam_torch"):
        return module.main(argv)
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    return module.main()


def _hold_calls(t_rec, j_rec, jax_root, port_root, drop_path=None):
    assert len(t_rec.calls) == len(j_rec.calls) > 0
    for (tc, te), (jc, je) in zip(t_rec.calls, j_rec.calls):
        want_cmd, want_env = _as_port(jc, je, jax_root, port_root, drop_path)
        assert tc == want_cmd
        assert te == want_env


@pytest.fixture()
def recorders(studies, tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("ODAM_FAULT_INJECT", raising=False)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    sources = {"": studies["dirs"]["synth_a"], "stale_track_bbox": studies["dirs"]["synth_b"]}
    return {"t": Recorder(sources), "j": Recorder(sources), "tmp": tmp_path,
            "data": studies["data"]}


def _without_seconds(rows):
    return [{k: v for k, v in r.items() if k not in ("seconds", "pipeline_seconds")}
            for r in rows]


@pytest.mark.parametrize("full", [False, True])
def test_ablate_commands_equal_jax(recorders, monkeypatch, full):
    d = recorders
    ck = ["--detector_ckpt", "/w/detr", "--associator_ckpt", "/w/assoc"]
    flags = ["--full"] if full else []
    t_out, j_out = str(d["tmp"] / "t_out"), str(d["tmp"] / "j_out")
    t_res = _drive(t_ablate, ["--data", d["data"], "--out", t_out] + ck + flags, monkeypatch,
                   d["t"])
    _drive(j_ablate, ["--data", d["data"], "--out", j_out] + ck + flags, monkeypatch, d["j"])
    _hold_calls(d["t"], d["j"], j_out, t_out)
    assert len(d["t"].calls) == 2 * (9 if full else 6)
    fault = d["t"].calls[-2]
    assert fault[1]["ODAM_FAULT_INJECT"] == "stale_track_bbox" and "--device" in fault[0]
    j_json = json.loads(open(os.path.join(j_out, "ablation.json")).read())
    assert _without_seconds(t_res) == _without_seconds(j_json)
    assert _without_seconds(json.loads(open(os.path.join(t_out, "ablation.json")).read())) \
        == _without_seconds(j_json)


def test_tune_threshold_commands_equal_jax(recorders, monkeypatch):
    d = recorders
    t_out, j_out = str(d["tmp"] / "t_out"), str(d["tmp"] / "j_out")
    argv = ["--data", d["data"], "--thresholds", "0.5,0.6", "--attach", "0.7,0.8",
            "--detector_ckpt", "/w/detr", "--associator_ckpt", "/w/assoc"]
    t_res = _drive(t_tune, argv + ["--out", t_out], monkeypatch, d["t"])
    _drive(j_tune, argv + ["--out", j_out], monkeypatch, d["j"])
    _hold_calls(d["t"], d["j"], j_out, t_out)
    assert len(d["t"].calls) == 8
    j_json = json.loads(open(os.path.join(j_out, "threshold_sweep.json")).read())
    assert _without_seconds(t_res) == _without_seconds(j_json)


def test_ablate_big_commands_and_matrix_equal_jax(recorders, monkeypatch):
    d = recorders
    for mod in (t_big, j_big):      # the fixture's three scenes stand in for the 18
        monkeypatch.setattr(mod, "BIG_EVAL_SEEDS", SEEDS)
    t_out, j_out = str(d["tmp"] / "t_out"), str(d["tmp"] / "j_out")
    argv = ["--data", d["data"], "--cells", "adam_exact_sampled,FAULT_stale_track_bbox",
            "--skip_tune", "--boot", "300", "--detector_ckpt", "/w/detr",
            "--associator_ckpt", "/w/assoc"]
    t_report = _drive(t_big, argv + ["--out", t_out], monkeypatch, d["t"])
    _drive(j_big, argv + ["--out", j_out], monkeypatch, d["j"])
    _hold_calls(d["t"], d["j"], j_out, t_out)
    assert all("--resume" in c for c, _ in d["t"].calls if "odam_torch.scripts.run_processor" in c)
    j_report = json.loads(open(os.path.join(j_out, "big_matrix.json")).read())
    assert t_report == j_report
    assert json.loads(open(os.path.join(t_out, "big_matrix.json")).read()) == j_report
    (decision,) = t_report["decisions"]
    assert decision["b"] == "FAULT_stale_track_bbox"
    # a second pass finds both cells complete and only scores
    d["t"].calls.clear()
    assert _drive(t_big, argv + ["--out", t_out], monkeypatch, d["t"]) == t_report
    assert d["t"].calls == []


def test_window_experiment_commands_equal_jax(recorders, monkeypatch):
    d = recorders
    t_out, j_out = str(d["tmp"] / "t_out"), str(d["tmp"] / "j_out")
    base = d["tmp"] / "jax_base"           # JAX copies an orbax directory as the base
    base.mkdir()
    (base / "odam_meta.json").write_text("{}")
    argv = ["--data", d["data"], "--detector_ckpt", "/w/detr", "--ft_steps", "2",
            "--ft_steps_w400", "3", "--min_views", "4", "--n_scenes", "3"]
    t_res = _drive(t_window, argv + ["--out", t_out], monkeypatch, d["t"])
    _drive(j_window, argv + ["--out", j_out, "--base_assoc", str(base)], monkeypatch, d["j"])
    _hold_calls(d["t"], d["j"], j_out, t_out, drop_path=j_window.HERE)
    trains = [c for c, _ in d["t"].calls if "odam_torch.examples.cli_rehearsal.train" in c]
    assert [(c[5], c[6]) for c in trains] == [("2", os.path.join(t_out, "assoc_w100_long_ckpt")),
                                              ("3", os.path.join(t_out, "assoc_w400_long_ckpt"))]
    envs = [e for c, e in d["t"].calls if "odam_torch.examples.cli_rehearsal.train" in c]
    assert [(e["ODAM_WINDOW"], e["ODAM_STREAM_FRAMES"], e["ODAM_HARD"]) for e in envs] == [
        ("100", "480", "1"), ("400", "480", "1")]
    j_res = json.loads(open(os.path.join(j_out, "window_experiment.json")).read())
    assert _without_seconds(t_res[:2]) == _without_seconds(j_res[:2])
    assert t_res[2] == j_res[2]          # the paired delta
    # the quirk: JAX parses "loss <x>"; the associator prints "nll <x>"
    assert [r["banked_losses"] for r in t_res[:2]] == [r["banked_losses"] for r in j_res[:2]] \
        == [[], []]
    # the base: the committed weights as a checkpoint without a global_step
    params, _, meta = t_ckpt.restore(os.path.join(t_out, "assoc_w100_long_ckpt"))
    assert meta == {}
    from odam_torch.models import convert

    want = dict(convert._flatten(convert.load_flax_npz(t_common.ASSOC_WEIGHTS)))
    got = dict(convert._flatten(params))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)


# ----------------------------------------------------------------- defaults

STUDIES = ("ci_eval", "tune_min_views", "audit_misses", "diagnose_recall", "ablate",
           "tune_threshold", "ablate_big", "window_experiment")
# read only: the committed hard split and the committed weights
READ_ONLY = {t_common.DATA_HARD, t_common.DETR_WEIGHTS, t_common.ASSOC_WEIGHTS}


def _defaults(name: str, monkeypatch) -> dict:
    """The parsed defaults of a study's command line."""
    class Parsed(Exception):
        pass

    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise Parsed(vars(parse(self, args, namespace)))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    mod = importlib.import_module(f"odam_torch.examples.cli_rehearsal.{name}")
    with pytest.raises(Parsed) as got:
        mod.main(["--result_dir", "r"] if name == "ci_eval" else [])
    return got.value.args[0]


@pytest.mark.parametrize("name", STUDIES)
def test_no_default_output_in_examples_or_artifacts(name, monkeypatch):
    """Every default path is the committed split or weights (read only) or
    lies under ``runs/cli_rehearsal/``; the model-running scripts default to
    the card."""
    defaults = _defaults(name, monkeypatch)
    paths = {k: v for k, v in defaults.items() if isinstance(v, str) and os.sep in v}
    assert paths
    for k, v in paths.items():
        if v in READ_ONLY:
            continue
        rel = os.path.relpath(os.path.abspath(v), ROOT)
        assert rel.startswith(os.path.join("runs", "cli_rehearsal")), (k, v)
    for v in paths.values():
        rel = os.path.relpath(os.path.abspath(v), ROOT)
        assert not rel.startswith(os.path.join("examples", "cli_rehearsal", "result")), v
    if "device" in defaults:
        assert defaults["device"] == "cuda"
    assert ("device" in defaults) == (name not in ("ci_eval", "tune_min_views",
                                                   "audit_misses"))


def test_diagnose_recall_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_diag.main(["--out", str(tmp_path / "d")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_diag.build_pipeline(t_common.ASSOC_WEIGHTS)
    assert not (tmp_path / "d").exists()
