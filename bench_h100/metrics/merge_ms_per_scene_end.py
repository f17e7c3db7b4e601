"""``merge_process`` of a scene end (the benchmark's ``bench.merge`` span,
host clock), the mean over the window's scene ends."""


def read(record):
    steps = record.get("steps") or []
    vals = [s["merge_s"] for s in steps if "merge_s" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
