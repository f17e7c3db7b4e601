"""Host time a scene end of issuing the solve (its launches are queued, not
waited for): the program's ``odam.optim.solve`` spans, both calls, over the
traced scene ends."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.optim.solve")
