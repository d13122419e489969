"""K3 (csrc/tile_bwd.cu, the tile backward): its least time per training
iteration at the H100's peaks (splatbench.roofline.k3_work on the
reference's pair counts) over its device time per iteration in the
traced calls."""

from splatbench import roofline
from splatbench.readings import kernel_share


def read(record, trace):
    return kernel_share(record, trace, "train", "tile_bwd_kernel",
                        roofline.k3_work, "traced_iterations")
