"""Share of the traced block's Adam iterations that ran as replays of the
solve's CUDA graph: 100 x the program's ``optim.graph_iterations`` over its
``optim.adam_iterations``.  None where the record has no trace or the
program counts neither (a program without the graph)."""
from bench_h100.program_spans import traced_block


def read(record):
    t = record.get("trace")
    block = traced_block() if t and t.get("n_units") else None
    if not block:
        return None
    replayed = block["counters"].get("optim.graph_iterations")
    iterations = block["counters"].get("optim.adam_iterations")
    return None if replayed is None or not iterations else 100.0 * replayed / iterations
