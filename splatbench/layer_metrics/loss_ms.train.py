"""Device milliseconds per traced iteration of the loss (L1, SSIM, the
regularisers) and autograd from the loss to the tile backward: the
program's stage clock (stages 'loss', 'loss_bwd', utils/profiling.py)."""

from splatbench.program_trace import stage_ms


def read(record, trace):
    return stage_ms(record, "train", ("loss", "loss_bwd"))
