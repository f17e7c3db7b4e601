"""pytest settings of the benchmark's own tests (``python3 -m pytest bench_h100``).

``h100`` marks a test that needs the card; the ``card`` fixture skips it
when no CUDA device is present, deciding at run time and never while a
module is imported.  ``tiny_root`` is a copy of the manifest and the data
files with the frames, lanes, stores, scenes and solves cut to a size the
CPU runs in seconds, for tests that drive a whole run on the CPU.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

TINY_FRAME = {"height": 96, "width": 128}
TINY_TRAFFIC = {
    "lanes16": {"lanes": 2, "pool_frames": 2, "checked_steps": 2, "trace_units": 2,
                "warmup_steps": 1},
    "scene_end": {"objects": 8, "fragmented": 3, "views": 32, "pool_scenes": 3,
                  "checked_from": 2, "checked_scene_ends": 1, "warmup_iterations": 2},
}
TINY_PIPELINE = {"optim_iters": 10, "optim_samples": 100, "max_objs": 16, "max_views": 32}


def pytest_configure(config):
    config.addinivalue_line("markers", "h100: needs an NVIDIA H100 (skips without a CUDA device)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def make_tiny_root(dest: Path) -> Path:
    """A root with BENCHMARK.json and the benchmark's data files (configs,
    traffic, limits, metric readers) under ``dest/pkg``, cut to tiny sizes."""
    shutil.copytree(PKG, dest / "pkg", ignore=shutil.ignore_patterns(
        "__pycache__", "reference", "mixes", "tests", "*.py"))
    shutil.copytree(PKG / "metrics", dest / "pkg" / "metrics", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["frame"] = dict(TINY_FRAME)
        cfg["pipeline"].update(TINY_PIPELINE)
        c["file"] = f"pkg/configs/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, cut in TINY_TRAFFIC.items():
        p = dest / "pkg" / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **cut}))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
