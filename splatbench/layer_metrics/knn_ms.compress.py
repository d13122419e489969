"""Device milliseconds per traced compression event of mercy's
30-neighbour search (ops/knn.py; csrc/knn.cu on a card): the program's
stage clock (stage knn, utils/profiling.py)."""

from splatbench.event_trace import stage_ms


def read(record, trace):
    return stage_ms(record, ("knn",), "traced_events")
