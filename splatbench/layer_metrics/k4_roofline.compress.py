"""K4 (csrc/tile_trans.cu, the SH-band cull's transmittance render): its
least time per render at the H100's peaks (splatbench.roofline_compress.
k4_work on the reference's pair counts of the sampled cameras) over its
device time per render in the traced cycle."""

from splatbench import roofline_compress
from splatbench.readings import kernel_share


def read(record, trace):
    return kernel_share(record, trace, "train", "tile_trans_kernel",
                        roofline_compress.k4_work, "traced_cull_renders")
