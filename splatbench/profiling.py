"""The benchmark's traced window: torch.profiler over a part of the
measured window, read back by splatbench.trace."""

from __future__ import annotations

import os
import tempfile

import torch

from splatbench import trace


class Tracer:
    """start() / stop() a profiled window named trace.WINDOW; read()
    (after the measured window: it writes and parses the trace) sets
    `summary`, its trace.Summary (None when tracing is off or the trace
    held no device work)."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.summary = None
        self._prof = self._span = None

    def start(self):
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._span = torch.profiler.record_function(trace.WINDOW)
        self._span.__enter__()

    def stop(self):
        if self._span is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self._span = None

    def read(self):
        if self._prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.summary = trace.read(path)
        finally:
            os.remove(path)
        self._prof = None
