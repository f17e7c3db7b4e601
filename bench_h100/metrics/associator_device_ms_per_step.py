"""Device time of the associator a step: kernels launched inside the
program's ``odam.associator`` range (the GNN, Sinkhorn and the LAP
decode), over the traced steps."""


def read(record):
    t = record.get("trace")
    if not t or not t["n_units"] or not t["device_s_under"].get("odam.associator"):
        return None
    return 1e3 * t["device_s_under"]["odam.associator"] / t["n_units"]
