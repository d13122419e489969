"""Alignment pads laid past binning's slack pool into the budget's unused
slots, per mille of that pool, mean over the traced frames' renders:
pad_spill_permille, which the program's fold (utils/profiling.py) derives
from binning's device counters num_rendered and total_padded.  A gauge of
the frames' density: 0 where every frame's pads fit in the pool; None
where the program has no such counter."""

from splatbench.program_trace import snapshot


def read(record, trace):
    if record.get("kind") != "view" or not record.get("traced_frames"):
        return None
    snap = snapshot()
    spill = None if snap is None else snap["counters"].get(
        "pad_spill_permille")
    if spill is None or not spill["count"]:
        return None
    return spill["sum"] / spill["count"]
