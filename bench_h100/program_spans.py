"""The program's own spans in the traced block, for the per-layer readers.

The port records its spans (``odam_torch.utils.metrics.span``) while the
profiler runs, and ``snapshot()["profiled"]`` holds those of the latest
traced block: per span name its count and total host seconds, and what the
registered counters counted over the block.  The traced block is the one
``run.py`` profiles after the window, in the same process, so the totals
over ``record["trace"]["n_units"]`` are a unit's host time of a stage.  A
program without spans (no ``snapshot``), a record without a trace, or a
span that never ran reads None.
"""
from __future__ import annotations


def traced_block() -> dict | None:
    """The program's latest traced block, or None."""
    from odam_torch.utils import metrics

    snapshot = getattr(metrics, "snapshot", None)
    return snapshot()["profiled"] if snapshot is not None else None


def _spans(record: dict, names: tuple[str, ...]) -> tuple[float, int] | None:
    t = record.get("trace")
    block = traced_block() if t and t.get("n_units") else None
    if not block:
        return None
    found = [block["spans"][n] for n in names if n in block["spans"]]
    calls = sum(s["count"] for s in found)
    return (sum(s["total_s"] for s in found), calls) if calls else None


def ms_per_unit(record: dict, *names: str) -> float | None:
    """The host milliseconds a traced unit spent in the spans ``names``
    (every call of each)."""
    got = _spans(record, names)
    return None if got is None else 1e3 * got[0] / record["trace"]["n_units"]


def us_per_count(record: dict, name: str, counter: str) -> float | None:
    """The host microseconds of span ``name`` over what ``counter`` (a dotted
    name, "optim.adam_iterations") counted in the same traced block."""
    got = _spans(record, (name,))
    if got is None:
        return None
    n = traced_block()["counters"].get(counter)
    return 1e6 * got[0] / n if n else None
