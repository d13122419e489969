"""Device milliseconds per traced compression event of mercy: the
redundancy metric's parts (the minimum projected pixel size, the
30-neighbour search, the sphere-ellipsoid intersections, the allocation)
and the selection: the program's stage clock (stages pixel_size, knn,
intersect, allocate, mercy_select, utils/profiling.py)."""

from splatbench.event_trace import stage_ms

STAGES = ("pixel_size", "knn", "intersect", "allocate", "mercy_select")


def read(record, trace):
    return stage_ms(record, STAGES, "traced_events")
