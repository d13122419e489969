"""What the program's tracing recorded of the compression events of a
traced run (reduced3dgs_torch/utils/profiling.py: the stages of mercy
and of the SH-band cull), per traced event.

As splatbench.program_trace: None where the program has no snapshot or
no such stage, where the ring dropped stamps, or where a stage did not
run as often as the traced events make it run.
"""

from __future__ import annotations

from splatbench.program_trace import snapshot


def stage_ms(record, names, count_key, units_key="traced_events"):
    """Device milliseconds of the named stages per traced event: each
    stage must have run record[count_key] times in the traced cycles."""
    units = record.get(units_key)
    counted = record.get(count_key)
    if record.get("kind") != "train" or not units or not counted:
        return None
    snap = snapshot()
    if snap is None or snap["stamps_dropped"] > 0:
        return None
    stages = snap["stages"]
    if any(stages.get(n, {}).get("count") != counted for n in names):
        return None
    return 1e3 * sum(stages[n]["s"] for n in names) / units
