"""Host time a step of the associator (the GNN, Sinkhorn and the LAP
decode): the program's ``odam.associator`` span, over the traced steps."""
from bench_h100.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "odam.associator")
