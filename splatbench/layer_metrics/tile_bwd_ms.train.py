"""Device milliseconds per traced iteration of the tile backward (K3
csrc/tile_bwd.cu): the program's stage clock (stage 'tile_bwd',
utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("tile_bwd",))
