"""Nothing the harness runs loads JAX, and the reference imports nothing of
the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100 import run

PKG = Path(__file__).resolve().parents[1]

REHEARSAL = """
import json, sys, torch
sys.path.insert(0, {root!r})
sys.path.insert(1, {pkg_parent!r})
from conftest import make_tiny_root
from pathlib import Path
from bench_h100 import run
torch.set_num_threads(2)
root = make_tiny_root(Path({tmp!r}))
out = run.run_cell({cell!r}, 3, 0.5, {trace}, torch.device("cpu"), root=root, pkg=root / "pkg")
print(json.dumps({{"forbidden": run.forbidden_modules(), "correct": out["correct"],
                  "odam_torch": "odam_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("cell,trace", [("odam_r50.lanes16", True),
                                        ("odam_r50.scene_end", False)])
def test_a_cpu_rehearsal_of_each_mix_loads_no_jax(tmp_path, cell, trace):
    code = REHEARSAL.format(root=str(PKG.parent), pkg_parent=str(PKG), tmp=str(tmp_path),
                            cell=cell, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(PKG.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [] and got["odam_torch"]


def test_forbidden_names_compare_the_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "odam_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "odam_tpu.ops", sys)
    assert run.forbidden_modules() == ["odam_tpu"]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((PKG / "reference").glob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"odam_torch", "odam_tpu", "jax", "jaxlib", "flax",
                                  "bench_h100"}, f.name
    code = ("import sys; sys.path.insert(0, %r); import bench_h100.reference.tracking, "
            "bench_h100.reference.scene_end; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('odam_torch', 'odam_tpu', 'jax')))" % str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr[-2000:]
