"""Kernels launched a step: the CUDA kernels in the traced window over the
traced steps."""


def read(record):
    t = record.get("trace")
    if not t or not t["n_units"]:
        return None
    return t["n_kernels"] / t["n_units"]
