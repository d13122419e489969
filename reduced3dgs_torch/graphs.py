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

import time

import torch


def kernel_counters():
    """The launch counters of the kernels a render, a fwd+bwd pass or a
    train step can reach, by name (K4 runs only in transmittance renders,
    which are never captured)."""
    from reduced3dgs_torch.ops import binning, tile_render

    return {"expand": binning.EXPAND, "tile_fwd": tile_render.TILE_FWD,
            "tile_bwd": tile_render.TILE_BWD,
            "seg_reduce_f32": tile_render.SEG_REDUCE_F32,
            "seg_reduce_packed": tile_render.SEG_REDUCE_PACKED}


class Captured:
    """``fn()`` captured as one CUDA graph on `device`.

    ``warm()`` runs `warmup` times first on a side stream (lazy library
    loads, kernel builds, cuDNN and autograd set-up happen there).
    ``out`` is what fn returned during the capture: its tensors are the
    graph's static outputs, rewritten by every replay.  ``launches`` holds
    each kernel's launches in one replay (its counter's rise during the
    capture) and ``capture_s`` the seconds of warm-up and capture."""

    def __init__(self, fn, warm, device, warmup: int = 1):
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                warm()
        torch.cuda.current_stream(device).wait_stream(side)
        kernels = kernel_counters()
        before = {n: k.launches for n, k in kernels.items()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        self.launches = {n: k.launches - before[n]
                         for n, k in kernels.items()}
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def replay(self):
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
