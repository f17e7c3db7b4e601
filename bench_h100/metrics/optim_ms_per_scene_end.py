"""Both ``optim_process`` calls of a scene end (the benchmark's
``bench.optim`` spans, host clock), the mean over the window's scene ends."""


def read(record):
    steps = record.get("steps") or []
    vals = [s["optim_s"] for s in steps if "optim_s" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
