"""Host time of issuing one Adam iteration: the program's ``odam.optim.solve``
spans over the ``optim.adam_iterations`` the traced block counted."""
from bench_h100.program_spans import us_per_count


def read(record):
    return us_per_count(record, "odam.optim.solve", "optim.adam_iterations")
