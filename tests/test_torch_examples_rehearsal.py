"""``odam_torch.examples.cli_rehearsal`` against the JAX package's
``examples/cli_rehearsal`` on the CPU.

- ``common`` / ``hard`` / ``analyze_visibility``: views (uint8 images
  exact), ground-truth rows and world tracks (within 1e-6), annotations and
  visibility flags equal;
- ``make_dataset``'s hard split on one seed at 3 frames, the port's and
  JAX's ``main_hard`` into two temporary directories: decoded images exact,
  the pose, intrinsic, meta, split and config text and the JSON equal; the
  port refuses the committed directories;
- the trainer's associator stream: the first batch (ghost rows, masks,
  pairs) equal to JAX's, with the hard split's layout seeds cut to one;
- the trainer's provenance rules: a wrong segment raises SystemExit, a
  mid-segment bank resumes at its step on the shifted schedule, and the
  frozen mode's grafted parameters load into the port's DETR and into JAX's
  ``model.apply`` (outputs within the DETR's bar, atol = rtol = 2e-4);
- ``probe_detector`` with the committed weights (``.npz`` against JAX's
  orbax checkpoint) over 2 eval views: the counts equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jax_examples import ROOT, jax_def, jax_module
from odam_torch.examples.cli_rehearsal import analyze_visibility as t_av
from odam_torch.examples.cli_rehearsal import common as t_common
from odam_torch.examples.cli_rehearsal import hard as t_hard
from odam_torch.examples.cli_rehearsal import make_dataset as t_make
from odam_torch.examples.cli_rehearsal import probe_detector as t_probe
from odam_torch.examples.cli_rehearsal import train as t_train
from odam_torch.models import convert, detr as t_detr, training as t_training
from odam_torch.scripts.train_associator import BATCH_KEYS
from odam_torch.utils import checkpoint as t_ckpt
from torch_threads import one_torch_thread  # noqa: F401

j_common = jax_module("cli_rehearsal/common.py")
j_hard = jax_module("cli_rehearsal/hard.py")
j_av = jax_module("cli_rehearsal/analyze_visibility.py")


def _same_views(tv, jv):
    assert len(tv) == len(jv)
    for a, b in zip(tv, jv):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype == np.uint8 or x.dtype.kind in "iu":
                np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)


def _same_tracks(t, j):
    (tt, tp), (jt, jp) = t, j
    assert len(tt) == len(jt) and sorted(tp) == sorted(jp)
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for k in tp:
        np.testing.assert_array_equal(tp[k], jp[k])


@pytest.mark.parametrize("part", ["common", "hard", "visibility"])
def test_scenes_views_and_tracks_equal_jax(part):
    if part == "common":
        for scene in t_common.SCENES:
            _same_views(t_common.scene_views(scene, phase=0.3),
                        j_common.scene_views(scene, phase=0.3))
            _same_tracks(t_common.gt_world_tracks(scene, np.random.default_rng(2), noise=0.03),
                         j_common.gt_world_tracks(scene, np.random.default_rng(2), noise=0.03))
        np.testing.assert_array_equal(t_common.norm(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)),
                                      j_common.norm(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)))
    elif part == "hard":
        for seed in (0, 101):
            assert repr(t_hard.make_hard_objects(seed)) == repr(j_hard.make_hard_objects(seed))
            _same_views(t_hard.hard_scene_views(seed, n_frames=6, phase=0.5),
                        j_hard.hard_scene_views(seed, n_frames=6, phase=0.5))
            _same_tracks(t_hard.hard_gt_world_tracks(seed, np.random.default_rng(1), n_frames=6),
                         j_hard.hard_gt_world_tracks(seed, np.random.default_rng(1), n_frames=6))
            assert t_hard.hard_scene_annotation(seed) == j_hard.hard_scene_annotation(seed)
        ta, ja = np.random.default_rng(5), np.random.default_rng(5)
        _same_views([t_hard.hard_random_view(ta) for _ in range(4)],
                    [j_hard.hard_random_view(ja) for _ in range(4)])
    else:
        t_out = t_av.visible_flags(1, n_frames=8)
        j_out = j_av.visible_flags(1, n_frames=8)
        for a, b in zip(t_out[1:], j_out[1:]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t_av.occlusion_audit(2)[1:], j_av.occlusion_audit(2)[1:]):
            np.testing.assert_array_equal(a, b)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_make_dataset_hard_equals_jax(tmp_path):
    j_make = jax_module("cli_rehearsal/make_dataset.py")
    j_make.main_hard(str(tmp_path / "jax"), seeds=(0,), n_frames=3)
    t_make.main_hard(str(tmp_path / "torch"), seeds=(0,), n_frames=3)
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "torch") and len(files) == 3 * 2 + 5
    for rel in files:
        a, b = tmp_path / "torch" / rel, tmp_path / "jax" / rel
        if rel.endswith(".jpg"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        elif rel.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        else:
            assert a.read_text() == b.read_text(), rel


@pytest.mark.parametrize("rel", [("examples", "cli_rehearsal", "data_hard"),
                                 ("examples", "cli_rehearsal", "data"), ("artifacts",)])
def test_make_dataset_refuses_committed_directories(rel):
    root = os.path.join(ROOT, *rel)
    before = _tree(root)
    with pytest.raises(ValueError, match="refusing"):
        t_make.main_hard(root, seeds=(0,), n_frames=1)
    assert _tree(root) == before


def _jax_association_samples(hard, seeds):
    """The sample loop of JAX's ``train.py associator`` (its lines, on
    ``odam_tpu`` and the JAX examples' functions), with the layout seeds cut."""
    from odam_tpu.data.datasets import build_association_sample

    ghost_rows = jax_def("cli_rehearsal/train.py", "_ghost_rows", np=np)
    T, N, W = (16 if hard else 8), 30, 100
    if hard:
        sources = []
        for seed in seeds:
            _, flags, _, _ = j_av.visible_flags(seed, n_frames=j_hard.N_FRAMES_HARD)

            def keep(fid, inst, flags=flags):
                return bool(flags[fid, inst])

            for ns in range(2):
                tracks, poses = j_hard.hard_gt_world_tracks(
                    seed, np.random.default_rng(ns), noise=0.05, keep=keep,
                    n_frames=j_hard.N_FRAMES_HARD)
                srng = np.random.default_rng(1000 + seed * 10 + ns)
                for t in tracks:
                    t[:, 13] = srng.uniform(0.6, 1.0, len(t))
                sources.append((tracks, poses))
        img_size = j_hard.IMG
    else:
        img_size = j_common.IMG
        sources = [j_common.gt_world_tracks(s, np.random.default_rng(ns), noise=0.03)
                   for s in j_common.SCENES for ns in range(4)]
    samples = []
    ghost_rng = np.random.default_rng(17)
    for tracks, poses in sources:
        for fid, T_wc in poses.items():
            if fid == 0:
                continue
            extra = ghost_rows(float(fid), T_wc, ghost_rng) if hard else None
            s = build_association_sample(tracks, float(fid), T, N, W, T_wc=T_wc,
                                         img_w=float(img_size), img_h=float(img_size),
                                         extra_dets=extra)
            if s is not None:
                P = 32 if hard else 16
                pairs = np.zeros((P, 2), np.int32)
                valid = np.zeros((P,), bool)
                k = min(len(s["gt_pairs"]), P)
                pairs[:k] = s["gt_pairs"][:k]
                valid[:k] = True
                s["gt_pairs"], s["pair_valid"] = pairs, valid
                samples.append(s)
    rng = np.random.default_rng(7)
    idx = rng.integers(0, len(samples), 16)
    return len(samples), {k: np.stack([samples[i][k] for i in idx]) for k in BATCH_KEYS}


@pytest.mark.parametrize("hard", [False, True])
def test_associator_first_batch_equals_jax(hard, monkeypatch):
    monkeypatch.delenv("ODAM_WINDOW", raising=False)
    monkeypatch.delenv("ODAM_STREAM_FRAMES", raising=False)
    seeds = (101,)
    samples = t_train.association_samples(hard, seeds=seeds)
    batch = next(t_train.association_batches(samples))
    n, want = _jax_association_samples(hard, seeds)
    assert len(samples) == n
    if hard:   # ghost rows at the stream's poses: detections beyond the ground truth's
        T_wc = t_hard.hard_scene_views(seeds[0], n_frames=2)[1][1]
        assert any(t_train._ghost_rows(1.0, T_wc, np.random.default_rng(s)) is not None
                   for s in range(8))
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)


def _seeded_ckpt(path, cfg, global_step):
    model = t_detr.build_detr(cfg, seed=0, device="cpu")
    t_ckpt.save(path, convert.state_dict_to_flax(model), meta={"global_step": global_step})
    return model


def test_wrong_segment_raises_and_boundaries_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    t_ckpt.save(ckpt, {"x": np.zeros(1, np.float32)}, meta={"global_step": 8})
    for seg in (0, 3):        # 8 is in neither [0, 4) nor [12, 16)
        with pytest.raises(SystemExit, match="global step 8"):
            t_train.check_provenance(ckpt, seg, 4)
    assert t_train.check_provenance(ckpt, 2, 4) == 0     # the start boundary of seg 2
    assert t_train.check_provenance(ckpt, 1, 6) == 2     # a bank inside seg 1 of 6 steps


def test_mid_segment_bank_resumes_at_its_step(tmp_path, monkeypatch):
    monkeypatch.setenv("ODAM_TRAIN_BATCH", "1")
    monkeypatch.setenv("ODAM_DECAY_STEPS", "12")
    monkeypatch.setenv("ODAM_BANK", "100")
    ckpt = str(tmp_path / "ckpt")
    cfg = t_common.make_detr(16, backbone_stage=3, backbone="tiny", use_kernels=False)
    _seeded_ckpt(ckpt, cfg, global_step=6)      # banked at step 2 of segment 1 (4-step)
    out = t_train.train_detector(1, 4, ckpt, "cpu", hard=True)
    assert out["steps"] == 2
    assert t_ckpt.load_meta(ckpt)["global_step"] == 8
    base = t_training.cosine_decay_schedule(5e-4, 12, alpha=0.02)
    lr = t_train._lr(1, 4, start_it=2)
    assert [lr(c) for c in range(3)] == [base(6 + c) for c in range(3)]
    frozen_lr = t_train._lr(1, 4, offset=False)
    assert frozen_lr(0) == base(0)


def test_frozen_graft_loads_into_port_and_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ODAM_TRAIN_BATCH", "2")
    monkeypatch.delenv("ODAM_HARD", raising=False)
    monkeypatch.delenv("ODAM_DECAY_STEPS", raising=False)
    ckpt = str(tmp_path / "ckpt")
    cfg = t_common.make_detr(12)
    seeded = convert.state_dict_to_flax(t_detr.build_detr(cfg, seed=0, device="cpu"))
    t_train.train_detector_frozen(0, 2, ckpt, "cpu", hard=False)
    assert os.path.exists(t_train.feature_cache_path(ckpt, 4, False))
    params, _, meta = t_ckpt.restore(ckpt)
    assert meta["global_step"] == 2
    flat = dict(convert._flatten(params))
    old = dict(convert._flatten(seeded))
    assert flat.keys() == old.keys()
    for k, v in flat.items():     # the backbone is the seeded one; the head trained
        if k[0] == "backbone":
            np.testing.assert_array_equal(v, old[k])
    assert not np.array_equal(flat[("class_embed", "kernel")], old[("class_embed", "kernel")])

    img = np.random.default_rng(0).normal(size=(1, 128, 128, 3)).astype(np.float32)
    tmodel = t_detr.build_detr(cfg, flax_params=params, device="cpu")
    with torch.no_grad():
        to = tmodel(torch.from_numpy(img))
    jmodel, _ = j_common.make_detr(12)
    jo = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(img))
    for k in ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size",
              "pred_depth"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=2e-4, rtol=2e-4,
                                   err_msg=k)


def test_probe_counts_equal_jax():
    from odam_tpu.utils import checkpoint as j_ckpt

    jmodel, _ = j_common.make_detr(16, backbone_stage=3, backbone="tiny")
    like = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, 192, 192, 3))),
                          jax.random.key(0))
    jparams = j_ckpt.restore(os.path.join(ROOT, "artifacts", "rehearsal_hard_detr_ckpt"), like)
    j_stats = jax_def("cli_rehearsal/probe_detector.py", "stats", np=np, jax=jax, jnp=jnp,
                      hard_scene_views=j_hard.hard_scene_views, norm=j_common.norm)
    tmodel = t_probe.load_detector(device="cpu")
    for visible_only in (False, True):
        t = t_probe.stats(tmodel, (0,), n_frames=2, visible_only=visible_only)
        j = j_stats(jmodel, jparams, (0,), n_frames=2, visible_only=visible_only)
        assert t == j and sum(t) > 0, (visible_only, t, j)
