"""Device milliseconds per traced iteration of binning (ops/binning.py: the
depth sort, K1 csrc/expand.cu, the key sort): the program's stage clock
(stage 'binning', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("binning",))
