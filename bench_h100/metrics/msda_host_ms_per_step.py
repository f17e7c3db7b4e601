"""Host time a step of issuing the multi-scale deformable attention calls (12
a step: 6 in the encoder, 6 in the decoder): the program's ``odam.msda``
spans, over the traced steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.msda")
