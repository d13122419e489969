"""Device milliseconds per traced iteration of the preprocess forward
(ops/preprocess.py) and the feature concatenation before it: the
program's stage clock (stage 'preprocess', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("preprocess",))
