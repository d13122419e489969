"""Device milliseconds per traced iteration of the gradient reduction (the
key sort and K5 / K6, csrc/seg_reduce.cu): the program's stage clock
(stage 'reduce', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("reduce",))
