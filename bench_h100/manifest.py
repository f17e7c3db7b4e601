"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root lists the configurations, cells and metrics.
Everything else is found by name under ``bench_h100/``:

- ``configs/<config>.json``: a configuration (its ``file`` in the manifest);
- ``traffic/<traffic>.json``: a traffic mix's parameters, with ``mix``
  naming the generator, ``mixes/<mix>.py``;
- ``metrics/<metric>.py``: the reader of a per-layer metric, a function
  ``read(record) -> float | None`` (``<base>.<part>`` falls back to
  ``metrics/<base>.py``);
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``.

So a new configuration, cell or per-layer metric is new files and new
manifest entries, and no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, pkg: Path = PKG) -> dict:
    with open(pkg / "traffic" / f"{name}.json") as f:
        return json.load(f)


def mix(name: str):
    """The generator module of a traffic kind: ``mixes/<name>.py``."""
    return importlib.import_module(f"bench_h100.mixes.{name}")


def limits(cell_name: str, pkg: Path = PKG) -> dict:
    with open(pkg / "limits" / f"{cell_name}.json") as f:
        return json.load(f)["limits"]


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, pkg: Path = PKG):
    """The ``read`` function of ``metrics/<metric>.py`` (a name may hold dots).
    A metric split by the end-to-end metric it moves, ``<base>.<part>``,
    that has no file of its own reads with ``metrics/<base>.py``."""
    name = metric
    while not (pkg / "metrics" / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return _load_file(pkg / "metrics" / f"{name}.py",
                      "bench_h100_metric_" + name.replace(".", "_").replace("-", "_")).read


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those that
    list it, and those without a ``workloads`` key that move (or are) an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in names else [])]
