"""Host time a scene end of packing the tracks into the solve's constraints
(NumPy): the program's ``odam.optim.constraints`` spans, both calls, over the
traced scene ends."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.optim.constraints")
