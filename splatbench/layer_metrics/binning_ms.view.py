"""Device milliseconds per traced frame of binning (ops/binning.py: the
depth sort, K1, the key sort): the program's stage clock (stage
'binning', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "view", ("binning",))
