"""Host time a step of the track store's update (attach, spawn, append and
the log write): the program's ``odam.store_update`` span, over the traced
steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.store_update")
