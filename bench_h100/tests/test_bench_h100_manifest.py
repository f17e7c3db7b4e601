"""The manifest and the files it names: found by name, within the contract's
limits, and open to a new cell or metric that comes as new files only."""
from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from bench_h100 import manifest, run

BENCH = manifest.load()
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")


def test_every_name_resolves_to_its_files():
    for c in BENCH["configs"]:
        cfg = manifest.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and c["file"].startswith("bench_h100/")
        assert cfg["reduced"] == c["reduced"] == []
    for w in BENCH["workloads"]:
        traffic = manifest.traffic(w["traffic"])
        assert hasattr(manifest.mix(traffic["mix"]), "Mix")
        limits = manifest.limits(w["name"])
        assert limits["max"] and limits["min"]
        for m in manifest.metrics_of(BENCH, w["name"], "per_layer"):
            assert callable(manifest.reader(m["name"]))
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("name", ["device_idle_pct.lanes", "device_idle_pct.scene_end"])
def test_a_split_metric_reads_with_its_base_reader(name):
    assert not (manifest.PKG / "metrics" / f"{name}.py").exists()
    read = manifest.reader(name)
    assert read({"trace": {"window_s": 2.0, "busy_s": 0.5}}) == 75.0
    assert read({"trace": None}) is None


def test_names_units_and_text_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024 and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert manifest.NAME_RE.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT_RE.match(e[key]), (e["name"], key)
            if "unit" in e:
                assert manifest.UNIT_RE.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert manifest.NAME_RE.match(w["traffic"]) and w["chips"] in (1, 4)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_each_cell_reports_what_its_layer_metrics_move():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(BENCH, w["name"], "end_to_end")}
        layer = manifest.metrics_of(BENCH, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_a_throwaway_cell_and_metric_come_as_new_files_only(tiny_root):
    """A new configuration, traffic mix, limits and per-layer reader, added as
    files with manifest entries, are found and run; no existing file changes."""
    pkg = tiny_root / "pkg"
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    shutil.copy(pkg / "configs" / "odam_r50.json", pkg / "configs" / "odam_r50_tiny.json")
    (pkg / "traffic" / "lanes1.json").write_text(json.dumps(
        {**json.loads((pkg / "traffic" / "lanes16.json").read_text()), "lanes": 1}))
    shutil.copy(pkg / "limits" / "odam_r50.lanes16.json",
                pkg / "limits" / "odam_r50_tiny.lanes1.json")
    (pkg / "metrics" / "steps_seen.py").write_text(
        "def read(record):\n    return float(len(record['steps']))\n")
    bench["configs"].append({"name": "odam_r50_tiny", "source": "https://example.org",
                             "file": "pkg/configs/odam_r50_tiny.json", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "odam_r50_tiny.lanes1", "config": "odam_r50_tiny",
                               "traffic": "lanes1", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "lane runner and host issue",
                               "moves": "frames_per_s", "workloads": ["odam_r50_tiny.lanes1"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("frames_per_s", "frame_p95_ms"):
            m["workloads"].append("odam_r50_tiny.lanes1")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    torch.set_num_threads(2)
    out = run.run_cell("odam_r50_tiny.lanes1", 7, 0.5, True, torch.device("cpu"),
                       root=tiny_root, pkg=pkg)
    assert out["metrics"]["steps_seen"]["value"] >= 1
    assert out["attempted"] >= 1 and out["compared"]["lane_steps"]["value"] >= 1


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_limits_for_what_its_check_compares(cell):
    limits = manifest.limits(cell)
    traffic = manifest.traffic(manifest.cell(BENCH, cell)["traffic"])
    counts = {"lanes": "lane_steps", "scene_end": "scene_ends"}[traffic["mix"]]
    assert counts in limits["min"] and all(v > 0 for v in limits["max"].values())
