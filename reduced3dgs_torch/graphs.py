"""Work captured once as a CUDA graph and replayed: the port's counterpart
of the JAX package's jitted loops (a ``lax.scan`` or ``fori_loop`` of
frames, steps or fwd+bwd passes in one launch).

Eager, every launch of a frame or step costs the host a Python call and
a CUDA launch call, and the card waits between them; replayed, the whole
captured sequence goes to the card at once.  A capture records the
kernels and copies that ``fn()`` enqueues; it runs none of them.  So
every input that changes between replays must be a tensor that ``fn``
reads in place, and ``fn`` must make no tensor from host data and read
no device value on the host: such a capture fails and raises (it never
falls back to the eager loop).  ``Looped`` is the plain version the CPU
runs: the same calls, eagerly.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import time

import torch

from reduced3dgs_torch.utils import profiling


def kernel_counters():
    """The launch counters of the kernels a render, a fwd+bwd pass or a
    train step can reach, by name (K4 runs only in transmittance renders,
    which are never captured)."""
    from reduced3dgs_torch.ops import binning, tile_render

    return {"expand": binning.EXPAND, "tile_fwd": tile_render.TILE_FWD,
            "tile_bwd": tile_render.TILE_BWD,
            "seg_reduce_f32": tile_render.SEG_REDUCE_F32,
            "seg_reduce_packed": tile_render.SEG_REDUCE_PACKED}


def all_kernel_counters():
    """kernel_counters and K4's (transmittance renders)."""
    from reduced3dgs_torch.ops import tile_render

    return {**kernel_counters(), "tile_trans": tile_render.TILE_TRANS}


LAUNCH_LOG = "R3DGS_LAUNCH_LOG"


def log_launches_at_exit(what: str) -> None:
    """Where the environment variable R3DGS_LAUNCH_LOG names a file, append
    one JSON line to it when this process exits: `what` and every
    kernel's launches in the process (what a caller that starts an entry
    point as a subprocess reads back, since the counters live in the
    process)."""
    path = os.environ.get(LAUNCH_LOG)
    if not path:
        return

    def write():
        line = {"what": what, "launches": {
            n: k.launches for n, k in all_kernel_counters().items()}}
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")

    atexit.register(write)


class Captured:
    """``fn()`` captured as one CUDA graph on `device`.

    ``warm()`` runs `warmup` times first on a side stream (lazy library
    loads, kernel builds, cuDNN and autograd set-up happen there).
    ``out`` is what fn returned during the capture: its tensors are the
    graph's static outputs, rewritten by every replay.  ``launches`` holds
    each kernel's launches in one replay (its counter's rise during the
    capture) and ``capture_s`` the seconds of warm-up and capture, which
    also go to the process-wide counter graph_capture_s (utils/
    profiling.py; spans r3dgs.graph.warm / capture / replay).  The stage
    clock's ring exists before the capture: the graph's stamp nodes write
    there at every replay while tracing is on."""

    def __init__(self, fn, warm, device, warmup: int = 1):
        t0 = time.perf_counter()
        self.device = torch.device(device)
        profiling.ring(self.device)
        with profiling.span("r3dgs.graph.warm"):
            side = torch.cuda.Stream(device=device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    warm()
            torch.cuda.current_stream(device).wait_stream(side)
        with profiling.span("r3dgs.graph.capture"):
            kernels = kernel_counters()
            before = {n: k.launches for n, k in kernels.items()}
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = fn()
            self.launches = {n: k.launches - before[n]
                             for n, k in kernels.items()}
            torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        profiling.tally("graph_capture_s", self.capture_s)

    def replay(self):
        """One replay, after the tracing flag follows the switch."""
        profiling.tracing(self.device)
        with profiling.span("r3dgs.graph.replay"):
            self.graph.replay()


class Looped:
    """The plain version of ``Captured`` (the CPU's): ``fn()`` runs once
    at construction, which counts each kernel's launches per call, and
    again at every replay; ``out`` is the last call's result."""

    capture_s = 0.0

    def __init__(self, fn):
        self.fn = fn
        kernels = kernel_counters()
        before = {n: k.launches for n, k in kernels.items()}
        self.out = fn()
        self.launches = {n: k.launches - before[n]
                         for n, k in kernels.items()}

    def replay(self):
        self.out = self.fn()


def runner(fn, device, warmup: int = 1):
    """A ``Captured`` graph of fn on a card (fn itself warms it up), a
    ``Looped`` fn on the CPU."""
    if torch.device(device).type == "cuda":
        return Captured(fn, fn, device, warmup)
    return Looped(fn)


def best_window(run, device, windows: int = 3, min_s: float = 0.02):
    """(seconds per replay in the best of `windows` timed windows, the
    replays per window).  Each window replays `run` back to back as many
    times as fill `min_s` by one timed replay, so that a short body's
    window stays far above the CUDA events' resolution."""
    run.replay()
    one = time_replays(run, 1, device)
    reps = max(1, math.ceil(min_s / max(one, 1e-9)))
    best = min(time_replays(run, reps, device) for _ in range(windows))
    return best / reps, reps


def time_rows(row_fns, device):
    """Yields (name, ms per call, replays a window, the launches per
    replay of the kernels that ran) for each of {name: a function of no
    argument}, as soon as it is timed: each a runner timed by
    best_window."""
    for name, fn in row_fns.items():
        run = runner(fn, device)
        sec, reps = best_window(run, device)
        yield (name, sec * 1e3, reps,
               {k: v for k, v in run.launches.items() if v})
        del run


def row_note(ms, reps, launched) -> str:
    """What follows a timed row's line: its unrounded ms, the replays a
    window and, where a kernel ran, its launches per replay."""
    extra = f"; launches per replay {launched}" if launched else ""
    return f"  ({ms:.5f} ms; {reps} replays a window{extra})"


def time_replays(run, reps: int, device) -> float:
    """Seconds of `reps` replays in a row, with no host read between
    them: CUDA events around the window on a card, the host clock on the
    CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            run.replay()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3
