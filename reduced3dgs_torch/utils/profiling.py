"""Profiling helpers (PyTorch) — counterpart of
reduced3dgs_tpu/utils/profiling.py and the reference's SyncedNVTX.

``synced_scope(name)`` is an NVTX range on the card (a record_function
range everywhere, so torch.profiler traces name it too); with the module
flag ``record_time`` set it fences the range with device
synchronisations and prints its wall time.  ``start_trace`` /
``stop_trace`` run torch.profiler and write a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

record_time = False  # module flag, like the reference's recordTime
_PROFILER = None


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def synced_scope(name: str):
    """A named range (NVTX on the card) with synchronisation fences and a
    printed wall time when record_time is set."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if record_time:
        _sync()
        t0 = time.perf_counter()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    if record_time:
        _sync()
        print(f"[profile] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")


def start_trace(logdir: str, cuda_only: bool = False):
    """Start a torch.profiler trace (CPU, and CUDA where present;
    `cuda_only`: the card's activity alone)."""
    global _PROFILER
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        if cuda_only:
            acts = acts[1:]
    os.makedirs(logdir, exist_ok=True)
    _PROFILER = torch.profiler.profile(activities=acts)
    _PROFILER.__enter__()
    _PROFILER.logdir = logdir


def stop_trace() -> str:
    """Stop the trace and write it as <logdir>/trace.json (Chrome trace
    format); returns the file's path."""
    global _PROFILER
    prof, _PROFILER = _PROFILER, None
    if prof is None:
        raise RuntimeError("stop_trace without start_trace")
    prof.__exit__(None, None, None)
    path = os.path.join(prof.logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
