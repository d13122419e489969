"""The port's tracing: stage clocks, host spans and counters — the
counterpart of reduced3dgs_tpu/utils/profiling.py and the reference's
SyncedNVTX.

Three instruments, one switch and one read-out.

* ``stage(name, device)`` marks a stage boundary on the current stream;
  a stage lasts until the next boundary, and ``END`` closes a step or a
  frame.  On a card it launches csrc/stamp.cu's one-thread kernel, which
  reads a device flag and, while it is set, writes (tag, %globaltimer)
  into a preallocated device ring; the tag is the stage's id.  A CUDA
  graph captured with tracing off holds these nodes (an early exit
  each), so it is traced later without a new capture; eager code does
  not launch them while tracing is off.  On the CPU the stamp is the
  host's ``time.perf_counter_ns()``.
* ``span(name)`` is a ``record_function`` range (and NVTX on a card), so
  a torch.profiler trace shows it on the clock of the device's kernels;
  while tracing is on it also adds its host seconds and calls.  While
  tracing is off it costs one flag check.
* ``count(name, value, aux)`` writes a device int32's value through the
  same ring (on the CPU: the host reads it), its tag the counter's id
  and `aux` above it; the fold works out the binning's pad need and its
  spill past the slack pool from a render's two counters, the aligned
  budget and the pool.
  ``add(name, value)`` adds a host value.  Both record only while
  tracing is on; ``tally`` adds whatever the switch (graph captures,
  which happen at set-up).

Tracing is on while an ``enable()`` is in force or a torch profiler
records.  The switch is read where work is launched: at every eager
stamp and every graph replay (graphs.Captured.replay), through
``tracing(device)``, which writes the card's flag when the switch has
changed since the last write: one fill, ordered on the stream before the
launch.  ``snapshot()`` synchronises, folds the rings and returns the
totals; ``reset()`` clears them.  ``start_trace`` / ``stop_trace`` run
torch.profiler and write a Chrome trace.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time

import torch

from reduced3dgs_torch.ops import _cuda

# stage boundaries in the order they follow each other: a boundary that
# does not come later than the open stage leaves that stage open
VIEW_STAGES = ("shade", "preprocess", "binning", "composite")
TRAIN_STAGES = ("preprocess", "binning", "composite", "loss", "loss_bwd",
                "tile_bwd", "reduce", "preprocess_bwd", "adam", "store")
END = "end"
STAGES = ("shade",) + TRAIN_STAGES + (END,)
# device counters: the render's instances (tagged with its aligned
# budget) and the padded slots its walk covers (tagged with its slack
# pool, b_pad less that budget); the fold adds PAD_NEED, the pads K1 lays
# out (total_padded less num_rendered) per mille of the pool (above 1000:
# pads spill into the budget's unused slots), SPILLED, the pads laid past
# the pool where the layout fits in b_pad, and PAD_SPILL, those per mille
# of the pool; the rows that csrc/preprocess_fwd.cu found visible,
# stamped only where a render took that kernel (its count: those renders)
COUNTERS = ("num_rendered", "total_padded", "preprocess_fused")
PAD_NEED = "pad_need_permille"
SPILLED = "pads_spilled"
PAD_SPILL = "pad_spill_permille"
_COUNTER_BASE = 64
_ID = {n: i for i, n in enumerate(STAGES)}
_ID.update({n: _COUNTER_BASE + i for i, n in enumerate(COUNTERS)})
_AUX = 16  # an entry's tag: its id, and above these bits what came with it
RING = 1 << 20  # entries of a device ring (16 B each)

STAMP = _cuda.Kernel(
    "stamp", "stamp_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])

_PROFILER = None


class _Ring:
    """One card's tracing flag, slot cursor and ring; `on` is the flag as
    last written.  Made with one stamp while the flag is clear, so the
    kernel is built and loaded before any capture holds it; never made
    of inference tensors (the first stamp may come in inference mode)."""

    def __init__(self, device):
        self.capacity = RING
        with torch.inference_mode(False):
            self.flag = torch.zeros(1, dtype=torch.int32, device=device)
            self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
            self.ring = torch.empty((RING, 2), dtype=torch.int64,
                                    device=device)
        self.on = False
        self.stamp(_ID[END])

    def stamp(self, tag, value=None):
        with torch.cuda.device(self.flag.device):
            STAMP(_cuda.ptr(self.flag), _cuda.ptr(self.cursor),
                  _cuda.ptr(self.ring), self.capacity, tag,
                  None if value is None else _cuda.ptr(value),
                  _cuda.stream_of(self.flag))

    def set(self, on: bool):
        if on != self.on:
            self.flag.fill_(int(on))
            self.on = on


class _Registry:
    """What the instruments have recorded since the last reset."""

    def __init__(self):
        self.enabled = 0  # enable() objects in force
        self.rings = {}  # card index -> _Ring
        self.host = []  # (tag, value) of the CPU's stamps and counters
        self.clear()

    def clear(self):
        self.stages = {}  # name -> [seconds, count]
        self.spans = {}  # name -> [seconds, calls]
        self.counters = {}  # name -> [sum, max, count]
        self.pending = {}  # source -> the (id, time) of its open stage
        self.dropped = 0
        self.left_open = 0


_REG = _Registry()


def _profiler_recording() -> bool:
    return torch._C._autograd._profiler_enabled()


def on() -> bool:
    """The switch: an enable() in force, or a torch profiler recording."""
    return _REG.enabled > 0 or _profiler_recording()


class enable:
    """Turns tracing on from the call until ``close()`` (or the end of a
    ``with`` block); several may be in force at once."""

    def __init__(self):
        _REG.enabled += 1
        self._open = True

    def close(self):
        if self._open:
            _REG.enabled -= 1
            self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None \
        else device.index


def ring(device) -> _Ring:
    """The card's ring, made on first use (never during a capture: a
    graph's nodes point at it, so it must exist before)."""
    idx = _index(device)
    r = _REG.rings.get(idx)
    if r is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("profiling.ring: make the ring before a "
                               "CUDA graph capture")
        r = _REG.rings[idx] = _Ring(torch.device("cuda", idx))
    return r


def tracing(device=None) -> bool:
    """The switch, written to `device`'s flag where that is a card whose
    flag differs (the check before a launch)."""
    t = on()
    if device is not None and torch.device(device).type == "cuda":
        r = _REG.rings.get(_index(device))
        if t or (r is not None and r.on):
            ring(device).set(t)
    return t


def _launch(device, tag, value=None):
    """One stamp on a card: in a capture always (the flag decides at each
    replay), eagerly only while tracing is on."""
    if not torch.cuda.is_current_stream_capturing() and not tracing(device):
        return
    ring(device).stamp(tag, value)


def stage(name: str, device) -> None:
    """A stage boundary: `name` starts here (END: the step or frame ends)."""
    device = torch.device(device)
    if device.type == "cuda":
        _launch(device, _ID[name])
    elif on():
        _host(_ID[name], time.perf_counter_ns())


def count(name: str, value, aux: int = 0) -> None:
    """A device counter (one of COUNTERS): the int32 0-dim tensor `value`.
    aux: with num_rendered the render's aligned budget, with total_padded
    its slack pool (b_pad - budget), from which the fold works out
    PAD_NEED, SPILLED and PAD_SPILL."""
    tag = _ID[name] | aux << _AUX
    if value.device.type == "cuda":
        _launch(value.device, tag, value)
    elif on():
        _host(tag, int(value))


def _host(tag, value):
    """The CPU's ring: a list that holds RING entries, as a card's does."""
    if len(_REG.host) < RING:
        _REG.host.append((tag, value))
    else:
        _REG.dropped += 1


def add(name: str, value=1) -> None:
    """A host counter: `value` added under `name` while tracing is on."""
    if on():
        tally(name, value)


def tally(name: str, value) -> None:
    """`value` added under the counter `name` whatever the switch."""
    c = _REG.counters.setdefault(name, [0, value, 0])
    c[0] += value
    c[1] = max(c[1], value)
    c[2] += 1


class _Span:
    __slots__ = ("name", "_rf", "_t0", "_nvtx")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        s = _REG.spans.setdefault(self.name, [0.0, 0])
        s[0] += dt
        s[1] += 1


_OFF = contextlib.nullcontext()


def span(name: str):
    """A named host range (see the module's docstring)."""
    return _Span(name) if on() else _OFF


def spanned(name: str):
    """Decorator: every call of the function is span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def _fold(entries, source):
    """Stage durations and counter values from one source's entries in
    the order they were written.  A boundary that comes later than the
    open stage closes it; any other leaves it open (counted, not
    timed).  The last open stage waits for the next fold.  A render's
    total_padded follows its num_rendered."""
    open_ = _REG.pending.pop(source, None)
    rendered = None
    for tag, value in entries:
        ident, aux = tag & ((1 << _AUX) - 1), tag >> _AUX
        if ident >= _COUNTER_BASE:
            name = COUNTERS[ident - _COUNTER_BASE]
            tally(name, value)
            if name == "num_rendered":
                rendered, aligned = value, aux
            elif name == "total_padded" and aux > 0 \
                    and rendered is not None:
                tally(PAD_NEED, (value - rendered) * 1000 // aux)
                if aligned > 0:
                    _fold_spill(value, rendered, aligned, aux)
            continue
        if open_ is not None:
            if ident > open_[0]:
                s = _REG.stages.setdefault(STAGES[open_[0]], [0.0, 0])
                s[0] += (value - open_[1]) * 1e-9
                s[1] += 1
            else:
                _REG.left_open += 1
        open_ = None if ident == _ID[END] else (ident, value)
    if open_ is not None:
        _REG.pending[source] = open_


def _fold_spill(padded, rendered, aligned, pool):
    """SPILLED and PAD_SPILL of one render: K1 lays the pads past the
    slack pool into the budget's unused slots where the whole layout fits
    (ops/binning.py:bin_keys_plain)."""
    spilled = 0 if padded > aligned + pool else \
        max(0, padded - pool - min(rendered, aligned))
    tally(SPILLED, spilled)
    tally(PAD_SPILL, spilled * 1000 // pool)


def _drain():
    """Fold every ring and the host's entries, emptying them."""
    for idx, r in _REG.rings.items():
        torch.cuda.synchronize(idx)
        n = int(r.cursor.item())
        _REG.dropped += max(0, n - r.capacity)
        entries = r.ring[:min(n, r.capacity)].cpu().tolist()
        r.cursor.zero_()
        _fold(entries, idx)
    host, _REG.host = _REG.host, []
    _fold(host, "host")


def snapshot() -> dict:
    """Synchronise and fold what was recorded since the last reset: per
    stage its seconds and count, per span its host seconds and calls, per
    counter its sum, max and count; the stamps the rings had no room for
    and the stages left open (a boundary out of order, or no boundary
    yet)."""
    _drain()
    return {
        "stages": {n: {"s": s, "count": c}
                   for n, (s, c) in _REG.stages.items()},
        "spans": {n: {"s": s, "calls": c}
                  for n, (s, c) in _REG.spans.items()},
        "counters": {n: {"sum": s, "max": m, "count": c}
                     for n, (s, m, c) in _REG.counters.items()},
        "stamps_dropped": _REG.dropped,
        "stages_open": _REG.left_open + len(_REG.pending),
    }


def reset() -> None:
    """Forget every stage, span and counter recorded so far."""
    _drain()
    _REG.clear()


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
