"""The readers of the program's own spans (``bench_h100/program_spans.py``):
each reads a number in a traced run of its cells, on the CPU at tiny size,
and None where the record has no trace."""
from __future__ import annotations

import pytest
import torch

from bench_h100 import manifest, run

BENCH = manifest.load()
NAMES = ("transport_host_ms_per_step", "detr_host_ms_per_step", "postprocess_host_ms_per_step",
         "track_inputs_host_ms_per_step", "associator_host_ms_per_step",
         "sinkhorn_host_ms_per_step", "store_update_host_ms_per_step",
         "constraints_ms_per_scene_end", "solve_issue_ms_per_scene_end",
         "solve_wait_ms_per_scene_end", "solve_host_us_per_iteration")
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["name"] in NAMES]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_span_reader_has_its_manifest_entry():
    assert len(SPAN_METRICS) == len(NAMES)
    assert all(m["source"] == "program_span" and m["workloads"] for m in SPAN_METRICS)


@pytest.mark.parametrize("cell", sorted({w for m in SPAN_METRICS for w in m["workloads"]}))
def test_each_span_reader_reads_a_traced_run_of_its_cells(tiny_root, cell):
    out = run.run_cell(cell, 2**31 + 17, 0.5, True, torch.device("cpu"), root=tiny_root,
                       pkg=tiny_root / "pkg")
    for m in SPAN_METRICS:
        if cell in m["workloads"]:
            got = out["metrics"][m["name"]]
            assert got["value"] > 0 and got["unit"] == m["unit"], m["name"]


@pytest.mark.parametrize("name", [m["name"] for m in SPAN_METRICS])
def test_a_record_without_a_trace_reads_none(name):
    read = manifest.reader(name)
    assert read({"trace": None, "steps": []}) is None
    assert read({}) is None
