"""Host time a step of postprocess, NMS and the detection rows: the
program's two ``odam.postprocess`` spans a step, over the traced steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.postprocess")
