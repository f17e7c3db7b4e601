"""``fused_attn_kernel``'s share of its roofline, as ``flash_attn_roofline``."""
from bench_h100.metrics_common import roofline_share


def read(record):
    return roofline_share(record, "fused", "fused_attn_kernel")
