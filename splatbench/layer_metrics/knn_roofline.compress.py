"""csrc/knn.cu (mercy's 30-neighbour search): its least time per search
at the H100's peaks (splatbench.roofline_compress.knn_work over the rows
searched) over its device time per compression event in the traced
cycle."""

from splatbench import roofline_compress
from splatbench import trace as tr

NEIGHBOURS = 30


def read(record, trace):
    if record.get("kind") != "train" or trace is None \
            or not record.get("traced_events") or not record.get("knn_rows"):
        return None
    spent = tr.device_seconds(trace, "knn_kernel")
    if spent <= 0:
        return None
    least = roofline_compress.knn_least_seconds(record["knn_rows"],
                                                NEIGHBOURS)
    return 100.0 * least / (spent / record["traced_events"])
