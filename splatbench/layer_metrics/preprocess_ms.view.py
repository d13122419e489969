"""Device milliseconds per traced frame of the preprocess
(ops/preprocess.py): the program's stage clock (stage 'preprocess',
utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "view", ("preprocess",))
