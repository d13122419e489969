"""The least time the chip needs for a frame's or a training step's work,
and for the compositing kernels alone: the yardstick of the roofline and
whole-work shares.

Frozen with the benchmark: the peaks and the per-pair operation counts
are copies of `chip_smoke.py`'s at commit d31b96e (MEM_BYTES_PER_S,
F32_OPS_PER_S, K2_OPS_*, K3_OPS_*: the least f32 arithmetic of a tile
walk per (pixel, instance) pair, an FFMA counted as 2).  The counts
they multiply come from the benchmark's own reference on the cell's
inputs, never from the program (splatbench.reference.raster.counts):
instances, binned primitives, blended pairs and stopped pixels.  Only
work that no correct program can skip is counted: a pair that blends or
stops a pixel; per pass, each instance's primitive index and each binned
primitive's 9 render floats read once (and its 9 gradients written
once); each pixel written or its gradient read once; each primitive's
parameters read once; for training Adam's state read and written once.
A pair walked past without blending, a per-instance record and an
instance's repeated reads are not counted, so a share stays below 100 %
whatever a later kernel skips or packs.
"""

from __future__ import annotations

# NVIDIA H100 SXM published peaks (data sheet, at its 700 W limit):
# HBM3 bytes per second and f32 operations outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# per walked pair 14, a blended pair adds 10, the pair that stops 3
K2_OPS_WALKED = 14
K2_OPS_BLEND = 10
K2_OPS_STOP = 3
# the backward's blended pair adds 24 and 9 adds of its per-instance sums
K3_OPS_BLEND = 24
K3_OPS_REDUCE = 9
INDEX_BYTES = 4  # an instance's primitive index
RENDER_FLOATS = 9  # a binned primitive's centre, conic, opacity, rgb
PARAM_FLOATS = 3 + 3 + 4 + 1  # position, log-scale, quaternion, opacity
LEAF_FLOATS = PARAM_FLOATS + 48  # with all 16 SH coefficients
ADAM_ACCESSES = 7  # read parameter, gradient, two moments; write three
SSIM_OPS_PER_PIXEL = 5 * 2 * 11 * 2 * 3  # 5 maps, 2 passes, 11 taps, 3 ch


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the bytes' and the operations' time at the peaks."""
    return max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k2_work(c, pixels):
    """(bytes, operations) of the forward composite of one frame, for the
    counts `c` (a dict of raster.counts)."""
    nbytes = (INDEX_BYTES * c["instances"] + 4 * RENDER_FLOATS * c["binned"]
              + 12 * pixels)
    ops = ((K2_OPS_WALKED + K2_OPS_BLEND) * c["blended"]
           + (K2_OPS_WALKED + K2_OPS_STOP) * c["stopped"])
    return nbytes, ops


def k3_work(c, pixels):
    """(bytes, operations) of the backward composite of one frame: the
    indices and render floats read, the binned primitives' gradients
    written, the pixels' gradient read."""
    nbytes = (INDEX_BYTES * c["instances"]
              + 2 * 4 * RENDER_FLOATS * c["binned"] + 12 * pixels)
    ops = ((K2_OPS_WALKED + K3_OPS_BLEND + K3_OPS_REDUCE) * c["blended"]
           + (K2_OPS_WALKED + K2_OPS_STOP) * c["stopped"])
    return nbytes, ops


def sh_floats(degree_counts):
    return sum(3 * (d + 1) ** 2 * n for d, n in enumerate(degree_counts))


def frame_work(c, pixels, degree_counts):
    """(bytes, operations) of a whole frame: every primitive's parameters
    and used SH coefficients read once, plus the composite."""
    b, o = k2_work(c, pixels)
    prims = sum(degree_counts)
    b += 4 * (PARAM_FLOATS * prims + sh_floats(degree_counts))
    return b, o


def step_work(c, pixels, degree_counts):
    """(bytes, operations) of a whole training iteration: the frame, the
    loss over the image pair, the backward composite, every primitive's
    gradient written and Adam's update of every leaf of every primitive
    (all 16 coefficients are trained, whatever the degree)."""
    prims = sum(degree_counts)
    b, o = frame_work(c, pixels, degree_counts)
    b3, o3 = k3_work(c, pixels)
    b += b3 + 12 * pixels  # the ground truth read
    o += o3 + 3 * SSIM_OPS_PER_PIXEL * pixels  # forward and backward
    b += 4 * LEAF_FLOATS * prims * (1 + ADAM_ACCESSES)
    o += 12 * LEAF_FLOATS * prims
    return b, o
