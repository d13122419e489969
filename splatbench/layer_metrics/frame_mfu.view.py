"""The whole frame's least time at the H100's peaks
(splatbench.roofline.frame_work on the reference's pair counts and the
configuration's sizes) over the measured time per frame of the traced
frames."""

from splatbench import roofline
from splatbench.readings import work_share


def read(record, trace):
    if trace is None:
        return None
    return work_share(record, "view", roofline.frame_work, trace.window_s,
                      record.get("traced_frames"))
