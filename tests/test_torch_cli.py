"""The port's CLI chain (``python -m odam_torch.scripts.run_processor`` then
``eval_scan2cad``) against the JAX package's (``scripts/run_processor.py``
then ``scripts/eval_scan2cad.py``) on the committed scene9700_00, with the
committed rehearsal checkpoints, ``--max_objs 32 --max_views 32``, float32,
on the CPU.

Tolerances: the same number of tracks, in the same order, with the integer
columns (frame id, class) exact and the rows within atol 1e-3 (pixels of a
192-px frame, metres); ``bboxes_dl`` within atol 1e-3; ``bboxes_qc`` at
oriented-3D IoU >= 0.95 per object; the F1 dicts equal.  The IoU bar is not
0.99: the Adam solve chatters across the kinks of its L1-of-maxima loss, so
a rounding difference grows to a fraction of a step, and JAX against itself
with one input moved by one ulp ends as far apart
(``test_optimize_superquadrics_matches`` in ``tests/test_torch_mapping.py``
prints both).  On this scene the port against JAX ends at IoU 0.977 for one
object with torch on one thread and 0.987 on eight (printed with ``-s``).
``run_both_chains`` drives both chains with other flags for
``tests/test_torch_cli_offline.py`` and ``tests/test_torch_cli_fast.py``.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from odam_torch.scripts import eval_scan2cad as t_eval
from odam_torch.scripts import run_processor as t_run
from odam_torch.utils.host_boxes import robust_box3d_iou
from odam_tpu.eval import scan2cad as j_s2c
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
HARD = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard")
SCENE = "scene9700_00"


def common_flags(split: str, out_dir: str) -> list[str]:
    return ["--config_path", os.path.join(HARD, "rehearsal.yaml"),
            "--scans_root", os.path.join(HARD, "scans"), "--sequences", split,
            "--short_side", "192", "--max_size", "192", "--max_objs", "32",
            "--max_views", "32", "--dtype", "float32", "--out_dir", out_dir]


def eval_flags(split: str, result_dir: str) -> list[str]:
    return ["--result_dir", result_dir, "--scan2cad", os.path.join(HARD, "full_annotations.json"),
            "--scans_root", os.path.join(HARD, "scans"), "--val_split", split,
            "--min_views", "10"]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Both chains run once: the JAX CLI in a subprocess (its own compile
    cache in a temporary directory), the port's in this process."""
    tmp = tmp_path_factory.mktemp("cli")
    split = str(tmp / "split.txt")
    with open(split, "w") as f:
        f.write(SCENE + "\n")
    jax_out, torch_out = str(tmp / "jax"), str(tmp / "torch")
    env = dict(os.environ, JAX_PLATFORMS="cpu", ODAM_COMPILE_CACHE=str(tmp / "jax_cache"),
               PYTHONPATH=os.path.abspath(ROOT))
    art = os.path.join(ROOT, "artifacts")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "run_processor.py"),
         *common_flags(split, jax_out),
         "--detector_ckpt", os.path.join(art, "rehearsal_hard_detr_ckpt"),
         "--associator_ckpt", os.path.join(art, "rehearsal_hard_assoc_ckpt")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rc = t_run.main([*common_flags(split, torch_out), "--device", "cpu",
                     "--detector_ckpt", os.path.join(art, "torch", "rehearsal_hard_detr.npz"),
                     "--associator_ckpt", os.path.join(art, "torch", "rehearsal_hard_assoc.npz")])
    assert rc == 0

    def load(d):
        with open(os.path.join(d, SCENE, SCENE), "rb") as f:
            return pickle.load(f)

    return {"split": split, "jax_dir": jax_out, "torch_dir": torch_out,
            "jax": load(jax_out), "torch": load(torch_out)}


def test_result_pickles_agree(chains):
    j, t = chains["jax"], chains["torch"]
    assert set(t) == {"tracks", "bboxes_qc", "bboxes_dl", "quadrics"}
    assert len(t["tracks"]) == len(j["tracks"]) >= 5
    for k, (a, b) in enumerate(zip(t["tracks"], j["tracks"])):
        assert isinstance(a, np.ndarray) and a.shape == b.shape, k
        np.testing.assert_array_equal(a[:, :2], b[:, :2], err_msg=f"track {k}")
        np.testing.assert_allclose(a, b, atol=1e-3, err_msg=f"track {k}")
        np.testing.assert_allclose(t["bboxes_dl"][k], j["bboxes_dl"][k], atol=1e-3)
        assert all(isinstance(x, np.ndarray) for x in t["quadrics"][k])
        assert not any(isinstance(x, torch.Tensor) for x in (*t["bboxes_qc"], *t["bboxes_dl"]))
    ious = [robust_box3d_iou(a, b) for a, b in zip(t["bboxes_qc"], j["bboxes_qc"])]
    print(f"\nbboxes_qc port vs JAX: min IoU {min(ious):.4f}")
    assert min(ious) >= 0.95, ious


def test_f1_tables_equal(chains, capsys):
    """Each package's eval on its own pickles, and each on the other's."""
    split = chains["split"]
    t_own = t_eval.main(eval_flags(split, chains["torch_dir"]))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "eval_scan2cad.py"),
         *eval_flags(split, chains["jax_dir"])],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.abspath(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "average: precision 0.7500 recall 0.4286 F1 0.5455" in out.stdout
    j_own = j_s2c.evaluate(chains["jax_dir"], os.path.join(HARD, "full_annotations.json"),
                           os.path.join(HARD, "scans"), [SCENE], min_views=10, verbose=False)
    assert t_own == j_own
    # the JAX eval on the port's pickles, the port's on the JAX pickles
    assert j_s2c.evaluate(chains["torch_dir"], os.path.join(HARD, "full_annotations.json"),
                          os.path.join(HARD, "scans"), [SCENE], min_views=10,
                          verbose=False) == j_own
    assert t_eval.main(eval_flags(split, chains["jax_dir"])) == j_own
    assert "average: precision 0.7500 recall 0.4286 F1 0.5455" in capsys.readouterr().out


def test_cli_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    """Without ``--device cpu`` and without a card, the CLI raises before it
    reads anything; ``--decode greedy`` and ``--profile fast --track_bbox
    sampled`` are ported paths and get that far."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--decode", "greedy"], ["--profile", "fast", "--track_bbox", "sampled"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_run.main(["--config_path", str(tmp_path / "missing.yaml"), *extra])


def test_greedy_decode_runs_the_chain(chains, tmp_path):
    """``--decode greedy`` (the port's on-device peel) over the first 8
    frames, with 8 object slots of 8 views: a pickle of the same schema with
    finite boxes."""
    art = os.path.join(ROOT, "artifacts", "torch")
    assert t_run.main([*common_flags(chains["split"], str(tmp_path)), "--device", "cpu",
                       "--decode", "greedy", "--max_frames", "8", "--min_views", "3",
                       "--max_objs", "8", "--max_views", "8",
                       "--detector_ckpt", os.path.join(art, "rehearsal_hard_detr.npz"),
                       "--associator_ckpt", os.path.join(art, "rehearsal_hard_assoc.npz")]) == 0
    with open(os.path.join(tmp_path, SCENE, SCENE), "rb") as f:
        out = pickle.load(f)
    assert len(out["tracks"]) >= 1 and all(np.isfinite(b).all() for b in out["bboxes_qc"])


def run_both_chains(tmp, extra: list[str], outliers: int = 0) -> None:
    """The JAX CLI in a subprocess (its own compile cache) while the port's
    runs here; then the pickles and the F1 tables compared: every object's
    ``bboxes_qc`` at IoU >= 0.95 but ``outliers`` of them, and those at
    >= 0.5."""
    split = str(tmp / "split.txt")
    with open(split, "w") as f:
        f.write(SCENE + "\n")
    jax_out, torch_out = str(tmp / "jax"), str(tmp / "torch")
    art = os.path.join(ROOT, "artifacts")
    env = dict(os.environ, JAX_PLATFORMS="cpu", ODAM_COMPILE_CACHE=str(tmp / "jax_cache"),
               PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "run_processor.py"),
         *common_flags(split, jax_out), *extra,
         "--detector_ckpt", os.path.join(art, "rehearsal_hard_detr_ckpt"),
         "--associator_ckpt", os.path.join(art, "rehearsal_hard_assoc_ckpt")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert t_run.main([*common_flags(split, torch_out), *extra, "--device", "cpu",
                           "--detector_ckpt", os.path.join(art, "torch", "rehearsal_hard_detr.npz"),
                           "--associator_ckpt",
                           os.path.join(art, "torch", "rehearsal_hard_assoc.npz")]) == 0
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]

    def load(d):
        with open(os.path.join(d, SCENE, SCENE), "rb") as f:
            return pickle.load(f)

    j, t = load(jax_out), load(torch_out)
    assert set(t) == {"tracks", "bboxes_qc", "bboxes_dl", "quadrics"}
    assert len(t["tracks"]) == len(j["tracks"]) >= 5
    for k, (a, b) in enumerate(zip(t["tracks"], j["tracks"])):
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a[:, :2], b[:, :2], err_msg=f"track {k}")
        np.testing.assert_allclose(a, b, atol=1e-3, err_msg=f"track {k}")
        np.testing.assert_allclose(t["bboxes_dl"][k], j["bboxes_dl"][k], atol=1e-3)
    ious = sorted(robust_box3d_iou(a, b) for a, b in zip(t["bboxes_qc"], j["bboxes_qc"]))
    print(f"\n{' '.join(extra)}: bboxes_qc port vs JAX, lowest IoUs {np.round(ious[:3], 4)}")
    assert ious[min(outliers, len(ious) - 1)] >= 0.95 and ious[0] >= 0.5, ious
    t_f1 = t_eval.main(eval_flags(split, torch_out))
    j_f1 = j_s2c.evaluate(jax_out, os.path.join(HARD, "full_annotations.json"),
                          os.path.join(HARD, "scans"), [SCENE], min_views=10, verbose=False)
    assert t_f1 == j_f1
