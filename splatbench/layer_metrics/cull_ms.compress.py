"""Device milliseconds per traced compression event of the SH-band cull:
its transmittance renders (two a camera) and their colour statistics:
the program's stage clock (stages cull_render, cull_stats, once a
render, utils/profiling.py)."""

from splatbench.event_trace import stage_ms


def read(record, trace):
    return stage_ms(record, ("cull_render", "cull_stats"),
                    "traced_cull_renders")
