"""The H100 benchmark of odam_torch: ``python3 -m bench_h100.run``."""
