"""odam_torch stands alone: it loads neither JAX nor odam_tpu, and its entry
points run on the card unless asked for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "odam_torch")


def _modules():
    import odam_torch

    names = ["odam_torch"]
    for info in pkgutil.walk_packages(odam_torch.__path__, "odam_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_odam_tpu():
    mods = _modules()
    assert len(mods) >= 20
    required = {"odam_torch.models." + m for m in ("matcher", "criterion", "training")}
    required |= {"odam_torch.data.datasets", "odam_torch.utils.checkpoint",
                 "odam_torch.utils.metrics", "odam_torch.scripts.train_detector",
                 "odam_torch.scripts.train_associator", "odam_torch.runtime.scene_parallel",
                 "odam_torch.parallel.mesh", "odam_torch.parallel.distributed",
                 "odam_torch.scripts.dryrun_distributed", "odam_torch.runtime.heuristic_tracker",
                 "odam_torch.eval.association", "odam_torch.eval.detection",
                 "odam_torch.utils.files", "odam_torch.utils.visualization"}
    required |= {"odam_torch.scripts." + m for m in (
        "run_tracking", "eval_association", "run_multi_view", "run_merge",
        "prior_calculation", "result_viewer")}
    assert required <= set(mods), required - set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'odam_tpu'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_flax_or_odam_tpu():
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "odam_tpu")
    found = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                found += [(path, n) for n in names if n.split(".")[0] in banned]
    assert not found, found


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from odam_torch import resolve_device
    from odam_torch.models import associator, detr
    from odam_torch.runtime import processor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small_detr = detr.DETRConfig(num_queries=4, hidden_dim=16, nheads=2, enc_layers=1,
                                 dec_layers=1, dim_feedforward=16, backbone="tiny",
                                 backbone_stage=2)
    small_assoc = associator.AssociatorConfig(descriptor_dim=16, keypoint_encoder=(78, 16),
                                              gnn_layers=("self",), self_gnn_layers=("self",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        detr.build_detr(small_detr)
    with pytest.raises(RuntimeError):
        associator.build_associator(small_assoc)
    d = detr.build_detr(small_detr, device="cpu")
    a = associator.build_associator(small_assoc, device="cpu")
    with pytest.raises(RuntimeError):
        processor.OdamPipeline(d, a)
    assert processor.OdamPipeline(d, a, device="cpu").device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("script", ["train_detector", "train_associator"])
def test_train_scripts_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path, script):
    import importlib

    cli = importlib.import_module(f"odam_torch.scripts.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--synthetic", "--steps", "1", "--out_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_run_stages_and_the_eval_clis_default_to_the_card(monkeypatch, tmp_path):
    """``run_stages``, ``run_tracking``, ``eval_association`` and
    ``run_multi_view`` raise without a card unless asked for the CPU."""
    import pickle

    from odam_torch.scripts import dryrun_distributed, eval_association, run_multi_view
    from odam_torch.scripts import run_tracking

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_distributed.run_stages("tiny", stages=("collectives",))
    arrays, report = dryrun_distributed.run_stages("tiny", "cpu", stages=("collectives",))
    assert report["device"] == "cpu" and arrays
    hard = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_tracking.main(["--scans_root", os.path.join(hard, "scans"),
                           "--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_association.main(["--tracks_dir", str(tmp_path)])
    with open(tmp_path / "tracks.pkl", "wb") as f:
        pickle.dump({"tracks": []}, f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_multi_view.main(["--tracks", str(tmp_path / "tracks.pkl"), "--scene", "s",
                             "--out", str(tmp_path / "mv.pkl")])
    assert not (tmp_path / "mv.pkl").exists()
