"""Arithmetic the per-layer readers share: the idle share of a traced
window and the roofline shares of the reference's pair counts."""

from __future__ import annotations

from splatbench import roofline
from splatbench import trace as tr


def idle_percent(record, trace, kind):
    """Percent of the traced window with no device operation running."""
    if record.get("kind") != kind or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mean_counts(record):
    """raster.counts averaged over the reference's sampled views, or
    None."""
    counts = record.get("counts")
    if not counts:
        return None
    return {k: sum(c[k] for c in counts) / len(counts) for k in counts[0]}


def kernel_share(record, trace, kind, fragment, work, per):
    """Percent of a kernel's measured device time per unit of work (an
    iteration or a frame) that its least time at the peaks takes; None
    without a trace, counts or kernel time."""
    counts = mean_counts(record)
    if record.get("kind") != kind or trace is None or counts is None:
        return None
    spent = tr.device_seconds(trace, fragment)
    if spent <= 0 or not record.get(per):
        return None
    pixels = record["width"] * record["height"]
    least = roofline.least_seconds(*work(counts, pixels))
    return 100.0 * least / (spent / record[per])


def work_share(record, kind, work, seconds, units):
    """Percent of the measured seconds per unit that the whole unit's
    least time at the peaks takes."""
    counts = mean_counts(record)
    if record.get("kind") != kind or counts is None or not units:
        return None
    pixels = record["width"] * record["height"]
    least = roofline.least_seconds(*work(counts, pixels,
                                         record["degree_counts"]))
    return 100.0 * least / (seconds / units)
