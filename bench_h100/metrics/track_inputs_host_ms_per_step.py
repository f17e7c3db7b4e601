"""Host time a step of the tracks' re-projection into the associator's
input: the program's ``odam.track_inputs`` span, over the traced steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.track_inputs")
