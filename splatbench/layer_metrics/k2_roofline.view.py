"""K2 (csrc/tile_fwd.cu, the forward composite): its least time per frame
at the H100's peaks (splatbench.roofline.k2_work on the reference's pair
counts) over its device time per frame in the traced frames."""

from splatbench import roofline
from splatbench.readings import kernel_share


def read(record, trace):
    return kernel_share(record, trace, "view", "tile_fwd_kernel",
                        roofline.k2_work, "traced_frames")
