"""Device milliseconds per traced iteration of the densification
statistics, Adam and the fused step's writes into its buffers: the
program's stage clock (stages 'adam', 'store', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("adam", "store"))
