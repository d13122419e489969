"""The whole training iteration's least time at the H100's peaks
(splatbench.roofline.step_work on the reference's pair counts and the
configuration's sizes) over the measured time per iteration of the
traced window."""

from splatbench import roofline
from splatbench.readings import work_share


def read(record, trace):
    return work_share(record, "train", roofline.step_work,
                      record.get("window_s", 0.0), record.get("iterations"))
