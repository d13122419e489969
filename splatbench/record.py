"""What a traffic generator hands back to the harness after one run."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Outcome:
    window_start: float  # time.perf_counter() at the window's start
    e2e: dict  # end-to-end metric name -> value
    record: dict  # what the per-layer readers read
    numbers: dict  # the numbers `correct` compares, by name
    attempted: int
    failed: int
    memory_peak: int  # bytes, the device's peak over the window
    notes: list = field(default_factory=list)  # earlier stderr lines
    trace: object = None  # splatbench.trace.Summary of the traced window
