"""Device time a step of multi-scale deformable attention: the kernels whose
name holds ``ms_deform_attn_kernel``, over the traced steps.  None where the
trace has no such kernel (a detector without it)."""

KERNEL = "ms_deform_attn_kernel"


def read(record):
    t = record.get("trace")
    if not t or not t["n_units"]:
        return None
    spent = sum(s for name, s in t["kernel_s_by_name"].items() if KERNEL in name)
    return 1e3 * spent / t["n_units"] if spent > 0 else None
