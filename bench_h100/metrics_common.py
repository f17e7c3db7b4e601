"""Arithmetic that several per-layer readers share."""
from __future__ import annotations


def roofline_share(record: dict, kind: str, kernel: str) -> float | None:
    """100 x the least time of the traced steps' ``kind`` attention calls
    over the time of the kernels whose name holds ``kernel``; None where
    the trace has no such kernel."""
    t = record.get("trace")
    if not t or not t["n_units"]:
        return None
    spent = sum(s for name, s in t["kernel_s_by_name"].items() if kernel in name)
    if spent <= 0:
        return None
    bound = sum(c.bound_s() for c in record.get("attention_calls", []) if c.kernel == kind)
    return 100.0 * bound * t["n_units"] / spent if bound else None

