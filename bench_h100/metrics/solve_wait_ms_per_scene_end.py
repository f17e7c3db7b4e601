"""Host time a scene end of the solve's readback, whose first read waits for
the device to finish the solve: the program's ``odam.optim.readback`` spans,
both calls, over the traced scene ends."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.optim.readback")
