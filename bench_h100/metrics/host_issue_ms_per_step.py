"""Host issue a step: the mean time from calling ``SceneParallelRunner.step``
to its return, before the readback (the benchmark's ``bench.step`` span,
host clock), over the window's steps."""


def read(record):
    steps = record.get("steps") or []
    issue = [s["issue_s"] for s in steps if "issue_s" in s]
    return 1e3 * sum(issue) / len(issue) if issue else None
