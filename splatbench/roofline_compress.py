"""The least time the chip needs for the compression iteration's kernels:
the yardstick of their roofline shares, in splatbench/roofline.py's
style and at its peaks.

K4 (csrc/tile_trans.cu, the SH-band cull's transmittance render) walks a
frame's instances as K2 does and adds, for each blended pair, the
transmittance before the blend to its primitive's sum and one to its
count.  The counts it multiplies come from the benchmark's own reference
on the cell's inputs (splatbench.reference.raster.counts), never from
the program.  Only work that no correct program can skip is counted: a
pair that blends or stops a pixel; each instance's primitive index and
each binned primitive's 6 render floats read once; each binned
primitive's sum and count written once.  No image is written.

The kNN (csrc/knn.cu): each searched point read once (12 B) and each
row's k neighbour rows written once (4 B each), and the distance to each
of its k neighbours computed (3 subtractions, 3 products, 2 sums).  How
many candidates a search must also reject is left out: a share of this
yardstick stays below 100 % whatever a later search skips.
"""

from __future__ import annotations

from splatbench.roofline import (
    INDEX_BYTES, K2_OPS_STOP, K2_OPS_WALKED, least_seconds,
)

TRANS_FLOATS = 6  # a binned primitive's centre, conic, opacity
TRANS_OUT_BYTES = 8  # a binned primitive's sum (f32) and count written
# a blended pair adds T to the sum, one to the count, and updates T (2)
K4_OPS_BLEND = 4
KNN_POINT_BYTES = 12
KNN_INDEX_BYTES = 4
KNN_OPS_PAIR = 8


def k4_work(c, pixels):
    """(bytes, operations) of one transmittance render, for the counts
    `c` (a dict of raster.counts); `pixels` is not counted (no image is
    written)."""
    nbytes = (INDEX_BYTES * c["instances"]
              + (4 * TRANS_FLOATS + TRANS_OUT_BYTES) * c["binned"])
    ops = ((K2_OPS_WALKED + K4_OPS_BLEND) * c["blended"]
           + (K2_OPS_WALKED + K2_OPS_STOP) * c["stopped"])
    return nbytes, ops


def knn_work(rows: int, k: int):
    """(bytes, operations) of one k-nearest-neighbour search of `rows`
    points."""
    return ((KNN_POINT_BYTES + KNN_INDEX_BYTES * k) * rows,
            KNN_OPS_PAIR * k * rows)


def knn_least_seconds(rows: int, k: int) -> float:
    return least_seconds(*knn_work(rows, k))
