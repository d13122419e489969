"""What the program's own tracing recorded in a traced run
(reduced3dgs_torch/utils/profiling.py: the stage clock inside its CUDA
graphs, its host spans and its counters), per traced iteration or frame.

The program traces while a torch.profiler records, so its snapshot after
the run holds exactly the traced calls or frames.  Every reading is None
where the program has no snapshot (a commit before its tracing), where
the ring dropped stamps, or where a stage did not run once in every
traced iteration or frame.
"""

from __future__ import annotations

UNITS = {"train": "traced_iterations", "view": "traced_frames"}


def snapshot():
    """The program's profiling.snapshot(), or None."""
    try:
        from reduced3dgs_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "snapshot", None)
    return None if read is None else read()


def _units_and_snapshot(record, kind):
    units = record.get(UNITS[kind]) if record.get("kind") == kind else None
    snap = snapshot() if units else None
    if snap is None or snap["stamps_dropped"] > 0:
        return None, None
    return units, snap


def stage_ms(record, kind, names):
    """Device milliseconds of the named stages per traced unit."""
    units, snap = _units_and_snapshot(record, kind)
    if snap is None:
        return None
    stages = snap["stages"]
    if any(stages.get(n, {}).get("count") != units for n in names):
        return None
    return 1e3 * sum(stages[n]["s"] for n in names) / units


def span_ms(record, kind, names, once_per_unit=False):
    """Host milliseconds of the named spans per traced unit
    (once_per_unit: each span entered once in every unit)."""
    units, snap = _units_and_snapshot(record, kind)
    if snap is None:
        return None
    spans = snap["spans"]
    calls = [spans.get(n, {}).get("calls", 0) for n in names]
    if not all(calls) or (once_per_unit and any(c != units for c in calls)):
        return None
    return 1e3 * sum(spans[n]["s"] for n in names) / units


def counter_sum(record, kind, name):
    """A program counter's sum over the process (e.g. its graph captures'
    seconds, counted whether tracing is on or not)."""
    if record.get("kind") != kind:
        return None
    snap = snapshot()
    if snap is None or name not in snap["counters"]:
        return None
    return float(snap["counters"][name]["sum"])
