"""Host time a step of the frames' upload, decode and cast: the program's
``odam.transport`` span (the lane metadata's copy and ``device_images``),
over the traced steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.transport")
