"""odam_torch's training data, checkpoints and train CLIs on the CPU.

The datasets and train transforms are the JAX package's numpy code, copied:
from the same numpy ``Generator`` state they must give exactly the same
arrays.  The checkpoints and the train CLIs are the port's own: a round
trip, a crash between the two renames, ``--resume_ckpt``, the weights read
by ``run_processor`` and by JAX's ``model.apply``.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from odam_torch import config as t_config
from odam_torch.data import datasets as t_ds
from odam_torch.data import scannet as t_scannet
from odam_torch.data import transforms as t_tf
from odam_torch.models import convert
from odam_torch.models import detr as t_detr
from odam_torch.scripts import run_processor, train_associator, train_detector
from odam_torch.utils import checkpoint
from odam_tpu.data import datasets as j_ds
from odam_tpu.data import scannet as j_scannet
from odam_tpu.data import transforms as j_tf
from odam_tpu.models import detr as j_detr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "examples", "cli_rehearsal", "data_hard", "rehearsal.yaml")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                      name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _objects(rng, n, w, h):
    rows = np.zeros((n, 12), np.float32)
    rows[:, 0] = rng.integers(0, 18, n)
    rows[:, 1:5] = rng.uniform(0.2, 0.8, (n, 4)) * [w, h, w, h]
    rows[:, 5:8] = rng.uniform(0.3, 2.0, (n, 3))
    rows[:, 8:10] = rng.normal(0, 5.0, (n, 2))
    rows[:, 10] = rng.uniform(0.5, 5.0, n)
    rows[:, 11] = rng.uniform(-np.pi, np.pi, n)
    return rows


def test_targets_and_angle_bins_equal():
    rng = np.random.default_rng(0)
    angles = rng.uniform(-7, 7, 200)
    _assert_same(t_ds.angle_to_class(angles), j_ds.angle_to_class(angles))
    objs = [_objects(rng, n, 1.0, 1.0) for n in (3, 0, 9)]
    _assert_same(tuple(t_ds.pack_targets(objs, 8)), tuple(j_ds.pack_targets(objs, 8)))
    T_wc = np.eye(4)
    T_wc[:3, :3] = j_scannet.quaternion_to_matrix(rng.normal(size=4))
    assert t_scannet.get_cam_azi(T_wc) == j_scannet.get_cam_azi(T_wc)


def test_train_transforms_equal():
    """Flip, multi-scale resize, canvas padding and the whole train
    transform from the same Generator state give the same arrays."""
    img = np.random.default_rng(1).integers(0, 255, (60, 80, 3), dtype=np.uint8)
    objs = _objects(np.random.default_rng(2), 4, 1.0, 1.0)
    _assert_same(t_tf.hflip_with_targets(img, objs), j_tf.hflip_with_targets(img, objs))
    got = t_tf.random_resize_train(img, objs, np.random.default_rng(3), scales=(48, 64))
    want = j_tf.random_resize_train(img, objs, np.random.default_rng(3), scales=(48, 64))
    _assert_same(got, want)
    _assert_same(t_tf.pad_to_canvas(got[0], 96, 128), j_tf.pad_to_canvas(want[0], 96, 128))
    rt, rj = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):          # both flip branches
        _assert_same(t_tf.train_transform(img, objs, rt, canvas=(800, 1344)),
                     j_tf.train_transform(img, objs, rj, canvas=(800, 1344)))


def test_detector_dataset_equal(tmp_path):
    """DetectorDataset on a JSON of PNG frames: the same batches."""
    rng = np.random.default_rng(5)
    records = []
    for i in range(5):
        h, w = (40, 56) if i % 2 else (48, 64)
        path = str(tmp_path / f"frame{i}.png")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)
        n = 0 if i == 3 else int(rng.integers(1, 5))
        records.append({"img_path": path, "objects": _objects(rng, n, w, h).tolist()})
    ann = tmp_path / "train.json"
    ann.write_text(json.dumps(records))
    tds, jds = t_ds.DetectorDataset(str(ann)), j_ds.DetectorDataset(str(ann))
    assert len(tds) == len(jds) == 4                       # the empty frame is dropped
    got = tds.batches(2, 32, 48, np.random.default_rng(6), epochs=2)
    want = jds.batches(2, 32, 48, np.random.default_rng(6), epochs=2)
    n = 0
    for (ti, tt), (ji, jt) in zip(got, want):
        _assert_same(ti, ji)
        _assert_same(tuple(tt), tuple(jt))
        n += 1
    assert n == 4


def test_association_samples_equal():
    """rows82_to_model79 (with and without a pose), build_association_sample
    with distractors, and AssociatorDataset's batches over the train
    script's synthetic scenes (themselves equal to JAX's script's)."""
    scenes_t = train_associator.synthetic_scenes(np.random.default_rng(7), n_scenes=2)
    scenes_j = _jax_script("train_associator").synthetic_scenes(np.random.default_rng(7),
                                                                n_scenes=2)
    _assert_same({k: tuple(v) for k, v in scenes_t.items()},
                 {k: tuple(v) for k, v in scenes_j.items()})
    rows = scenes_t["synthetic_0"][0]
    T_wc = np.eye(4)
    T_wc[:3, 3] = [0.5, -1.0, 1.5]
    for pose in (None, T_wc):
        _assert_same(t_ds.rows82_to_model79(rows, pose, 640.0, 480.0),
                     j_ds.rows82_to_model79(rows, pose, 640.0, 480.0))
    extra = np.random.default_rng(8).normal(size=(2, 82)).astype(np.float32)
    args = (scenes_t["synthetic_1"], 20.0, 8, 6, 10, T_wc, 640.0, 480.0, extra)
    _assert_same(t_ds.build_association_sample(*args), j_ds.build_association_sample(*args))
    tds = t_ds.AssociatorDataset(scenes_t, max_tracks=8, max_dets=6, window=10)
    jds = j_ds.AssociatorDataset(scenes_j, max_tracks=8, max_dets=6, window=10)
    assert len(tds) == len(jds) > 0
    got = tds.batches(4, np.random.default_rng(9), epochs=1)
    want = jds.batches(4, np.random.default_rng(9), epochs=1)
    n = 0
    for a, b in zip(got, want):
        _assert_same(a, b)
        n += 1
    assert n > 3


def test_synthetic_batches_equal():
    jmod = _jax_script("train_detector")
    got = train_detector.synthetic_batches(2, 16, 24, 18, 8, np.random.default_rng(10))
    want = jmod.synthetic_batches(2, 16, 24, 18, 8, np.random.default_rng(10))
    for _ in range(2):
        (ti, tt), (ji, jt) = next(got), next(want)
        _assert_same(ti, ji)
        _assert_same(tuple(tt), tuple(jt))


def test_checkpoint_round_trip_and_crash_between_renames(tmp_path):
    """save/restore returns the tree, the optimizer state and the meta;
    after a crash between the two renames (the old checkpoint moved to
    .bak, the complete new one still .tmp) restore finds .tmp, and with an
    incomplete .tmp (no meta yet) it falls back to .bak."""
    path = str(tmp_path / "ckpt_2")
    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "bin_score": np.float32(1.5) * np.ones((), np.float32)}
    opt = {"count": np.asarray(2.0, np.float32), "mu/a/kernel": np.ones((3, 2), np.float32)}
    checkpoint.save(path, tree, opt, {"step": 2})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2"]
    params, opt_state, meta = checkpoint.restore(path)
    _assert_same(params, tree)
    _assert_same(opt_state, opt)
    assert meta == {"step": 2} == checkpoint.load_meta(path)

    newer = {"a": {"kernel": tree["a"]["kernel"] + 1}, "bin_score": tree["bin_score"]}
    checkpoint.save(path + ".new", newer, None, {"step": 3})
    os.rename(path, path + ".bak")                 # the first rename happened ...
    os.rename(path + ".new", path + ".tmp")        # ... the second did not
    assert checkpoint.latest_path(path) == path + ".tmp"
    _assert_same(checkpoint.restore(path)[0], newer)
    os.remove(os.path.join(path + ".tmp", checkpoint.METAFILE))      # .tmp incomplete
    params, opt_state, meta = checkpoint.restore(path)
    assert checkpoint.latest_path(path) == path + ".bak" and meta == {"step": 2}
    _assert_same(params, tree)
    checkpoint.save(path, newer, None, {"step": 3})        # a later save cleans up
    assert sorted(os.listdir(tmp_path)) == ["ckpt_2"]
    assert checkpoint.load_meta(path) == {"step": 3}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both train CLIs on the CPU with the tiny rehearsal config: 2 steps at
    once, and 1 step then --resume_ckpt to 2."""
    root = tmp_path_factory.mktemp("train")
    det = ["--config_path", TINY_CFG, "--synthetic", "--img_h", "64", "--img_w", "64",
           "--batch_size", "2", "--log_every", "1", "--device", "cpu", "--dtype", "float32"]
    assoc = ["--config_path", TINY_CFG, "--synthetic", "--batch_size", "2", "--log_every", "1",
             "--device", "cpu"]
    out = {}
    for name, cli, argv in (("detr", train_detector, det), ("assoc", train_associator, assoc)):
        full, part = str(root / name / "full"), str(root / name / "part")
        assert cli.main(argv + ["--steps", "2", "--out_dir", full]) == 0
        assert cli.main(argv + ["--steps", "1", "--out_dir", part]) == 0
        assert cli.main(argv + ["--steps", "2", "--out_dir", part, "--resume_ckpt",
                                os.path.join(part, "ckpt_1")]) == 0
        out[name] = (full, part)
    return out


@pytest.mark.parametrize("name", ["detr", "assoc"])
def test_train_cli_resumes_at_the_saved_step(trained, name):
    """Two steps at once and one step plus a resumed one give the same
    weights, optimizer state and meta step; the log has a line a step."""
    full, part = trained[name]
    a, b = checkpoint.restore(os.path.join(full, "ckpt_2")), checkpoint.restore(
        os.path.join(part, "ckpt_2"))
    _assert_same(a[0], b[0])
    _assert_same(a[1], b[1])
    assert a[2]["step"] == b[2]["step"] == 2 and float(a[1]["count"]) == 2.0
    with open(os.path.join(full, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2]
    assert all(np.isfinite(r["total" if name == "detr" else "loss"]) for r in log)


def test_trained_checkpoints_load_into_run_processor_and_jax(trained):
    """run_processor.build_models reads both checkpoint directories; the
    detector's params.npz under JAX's model.apply gives the port's forward."""
    cfg = t_config.merge_cfg([TINY_CFG])
    full_d, full_a = trained["detr"][0], trained["assoc"][0]
    detr, assoc = run_processor.build_models(cfg, os.path.join(full_d, "ckpt_2"),
                                             os.path.join(full_a, "ckpt_2"), "exact", "cpu")
    params = checkpoint.restore(os.path.join(full_d, "ckpt_2"))[0]
    _assert_same(convert.state_dict_to_flax(detr), params)
    _assert_same(convert.state_dict_to_flax(assoc),
                 checkpoint.restore(os.path.join(full_a, "ckpt_2"))[0])
    img = np.random.default_rng(11).normal(size=(1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = detr(torch.from_numpy(img))
    npz = convert.load_flax_npz(os.path.join(full_d, "ckpt_2", checkpoint.PARAMS))
    jm = j_detr.DETR(j_detr.DETRConfig.from_cfg(cfg))
    want = jax.jit(jm.apply)({"params": jax.tree.map(jnp.asarray, npz)}, jnp.asarray(img))
    for k in ("pred_logits", "pred_boxes", "pred_angle", "pred_depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5, rtol=2e-5,
                                   err_msg=k)
    assert isinstance(detr, t_detr.DETR) and detr.config.use_kernels
