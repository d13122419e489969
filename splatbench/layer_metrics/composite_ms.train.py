"""Device milliseconds per traced iteration of the composite (K2
csrc/tile_fwd.cu, its feature gather, the unpacking and the background):
the program's stage clock (stage 'composite', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("composite",))
