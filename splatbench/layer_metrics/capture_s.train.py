"""Seconds of the process's CUDA graph warm-ups and captures
(graphs.Captured, the program's counter graph_capture_s): set-up's share
that capturing takes."""

from splatbench.program_trace import counter_sum


def read(record, trace):
    return counter_sum(record, "train", "graph_capture_s")
