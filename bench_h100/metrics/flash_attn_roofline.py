"""``flash_attn_kernel``'s share of its roofline: the least time the chip
could take for the flash calls of the traced steps (bench_h100.roofline,
from the shapes called) over the kernel's time in the trace."""
from bench_h100.metrics_common import roofline_share


def read(record):
    return roofline_share(record, "flash", "flash_attn_kernel")
