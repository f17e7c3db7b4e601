"""Host time a step of Sinkhorn's iterations: the program's ``odam.sinkhorn``
span, over the traced steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.sinkhorn")
