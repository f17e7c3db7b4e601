"""``ms_deform_attn_kernel``'s share of its roofline: the least time the chip
could take for the MSDA calls of the traced steps (the larger of their bytes
over HBM bandwidth and their FLOPs over the float32 peak,
``bench_h100.roofline_deformable.MSDACall``, from the shapes called) over
the kernel's time in the trace.  None where the trace has no such kernel or
the record no MSDA calls."""

KERNEL = "ms_deform_attn_kernel"


def read(record):
    t = record.get("trace")
    if not t or not t["n_units"]:
        return None
    spent = sum(s for name, s in t["kernel_s_by_name"].items() if KERNEL in name)
    bound = sum(c.bound_s() for c in record.get("msda_calls", []))
    return 100.0 * bound * t["n_units"] / spent if spent > 0 and bound else None
