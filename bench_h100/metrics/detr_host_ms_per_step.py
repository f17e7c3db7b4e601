"""Host time a step of the detector's issue: the program's ``odam.detr``
span, over the traced steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.detr")
