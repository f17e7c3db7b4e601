"""Device time of the detector a step: kernels launched inside the program's
``odam.detr`` range, over the traced steps."""


def read(record):
    t = record.get("trace")
    if not t or not t["n_units"] or not t["device_s_under"].get("odam.detr"):
        return None
    return 1e3 * t["device_s_under"]["odam.detr"] / t["n_units"]
