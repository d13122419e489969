"""Device milliseconds per traced iteration of the rest of autograd (the
preprocess backward): the program's stage clock (stage 'preprocess_bwd',
utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("preprocess_bwd",))
