"""Reading a torch.profiler Chrome trace: the device's busy time in a
traced window, device time by operation name, and the longest idle gaps
named by what the host was doing.

Frozen with the benchmark: the reading of device events follows the
port's `reduced3dgs_torch/profile_trace.py:read_trace` at commit d31b96e
(the same categories of device work, each event its duration); the
union of busy intervals, the window and the gaps are the benchmark's
own.  A later change to the program does not change this file.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import NamedTuple

import numpy as np

# Chrome-trace categories of the work a CUDA stream runs
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host-side categories whose spans name what the host was doing
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "splatbench.window"
TOP = 10
NAME = 160  # characters of an op's name kept in the breakdown


class Summary(NamedTuple):
    window_s: float  # length of the traced window
    busy_s: float  # union of device activity inside it
    by_name: dict  # device op name -> seconds inside the window
    top_ops: list  # [name, seconds], largest first, at most TOP
    idle_gaps: list  # [host activity, seconds] of the longest gaps


def _union(intervals):
    """Merged, sorted intervals of [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_name(host, t):
    """The innermost host span that covers time t, or "host idle"."""
    starts, ends, names = host
    inside = np.nonzero((starts <= t) & (ends >= t))[0]
    if inside.size == 0:
        return "host idle"
    return names[inside[np.argmin(ends[inside] - starts[inside])]]


def summarise(events, window_name: str = WINDOW) -> Summary | None:
    """Summary of the device work inside the span `window_name`; None
    when the trace holds no such span or no device work in it."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == window_name
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], defaultdict(float)
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e["name"]] += (t - s) / 1e6
    if not dev:
        return None
    busy = _union(dev)
    busy_us = sum(e - s for s, e in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    hs = [e for e in spans if e.get("cat") in HOST_CATS
          and e.get("name") != window_name]
    host = (np.array([float(e["ts"]) for e in hs]),
            np.array([float(e["ts"]) + float(e["dur"]) for e in hs]),
            [e["name"] for e in hs])
    longest = [[_host_name(host, 0.5 * (s + e)), (e - s) / 1e6]
               for s, e in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary((w1 - w0) / 1e6, busy_us / 1e6, dict(by_name),
                   [[n[:NAME], t] for n, t in top],
                   [[n[:NAME], t] for n, t in longest])


def read(path: str, window_name: str = WINDOW) -> Summary | None:
    with open(path) as f:
        return summarise(json.load(f)["traceEvents"], window_name)


def device_seconds(summary: Summary, fragment: str) -> float:
    """Seconds of device ops whose name contains `fragment`."""
    return sum(s for n, s in summary.by_name.items() if fragment in n)
