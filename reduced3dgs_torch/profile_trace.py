"""Device time of bench's fwd+bwd loop per op, from a profiler trace: the
port's counterpart of root profile_trace.py.

    python -m reduced3dgs_torch.profile_trace [width height n_prims budget
        iters [smin smax]] [--device cpu] [--logdir DIR]

The step is root's: bench.FwdBwd chained (one differentiable render of
bench's scene, its default_rng(0) draws, the camera at (0, 0, -3.6), the
L1 mean against a zero target and the gradients of the five leaves),
with the gradient reduction of R3DGS_GRAD_REDUCE (default f32); each
step reads the last step's loss (xyz + 1e-30 * l_prev, a zero carry at
the start), so the steps form one chain.  The step is captured once as a
CUDA graph (graphs.runner; eager on the CPU) and replayed `iters` times under
torch.profiler (utils/profiling.py start_trace / stop_trace, the Chrome
trace written to --logdir).  Printed: num_rendered, the wall time per
iteration and pixels/s, then per device line (each CUDA stream; on the
CPU each thread's op events, by self time) the busy time and the span
per iteration, the top TOP ops by time per iteration and "(other N ops)".

``read_trace`` is the one reader of a profile in the port: chip_smoke.py's
frame, step and group profiles go through it (``trace_call``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict
from typing import NamedTuple

TOP = 60  # ops listed per line
DEFAULTS = (512, 512, 1 << 17, 3 << 18, 20)  # width height n budget iters
SCALES = (0.008, 0.040)
# Chrome-trace categories of the work a CUDA stream runs
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls that hand work to the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cuLaunchKernel")


class Line(NamedTuple):
    """One device line of a trace, per iteration."""
    name: str
    busy_ms: float  # the ops' summed (self) time
    span_ms: float  # first start to last end
    ops: list  # (ms, count, name) per iteration, largest first


class Trace(NamedTuple):
    lines: list  # Line, by busy time
    host_calls: dict  # host runtime call name -> calls (whole trace)

    def kernel_rows(self):
        """The ops of every line merged by name: (ms, count, name) per
        iteration, largest first."""
        rows = defaultdict(lambda: [0.0, 0])
        for line in self.lines:
            for ms, count, name in line.ops:
                rows[name][0] += ms
                rows[name][1] += count
        return sorted(((ms, c, n) for n, (ms, c) in rows.items()),
                      reverse=True)

    @property
    def busy_ms(self):
        return sum(line.busy_ms for line in self.lines)


def _self_times(events):
    """(event, self us) of one thread's nested op events: each event's
    duration less its direct children's."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in events:
        end = e["ts"] + e["dur"]
        while stack and stack[-1][1] <= e["ts"]:
            stack.pop()
        entry = [e, end, e["dur"]]
        if stack:
            stack[-1][2] -= e["dur"]
        stack.append(entry)
        out.append(entry)
    return [(e, max(self_us, 0.0)) for e, _, self_us in out]


def read_trace(path: str, iters: int = 1) -> Trace:
    """A Chrome trace of torch.profiler as per-line op tables.

    The lines are the CUDA streams (kernels, copies and sets, each event
    its duration) where the trace holds device work, else the CPU threads
    (op events by self time).  Times and counts are divided by `iters`."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    host = defaultdict(int)
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            host[e["name"]] += 1
    by_line = defaultdict(list)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if dev:
        for e in dev:
            args = e.get("args", {})
            key = (f"device {args.get('device', e.get('pid'))} stream "
                   f"{args.get('stream', e.get('tid'))}")
            by_line[key].append((e, float(e["dur"])))
    else:
        threads = defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op":
                threads[e.get("tid")].append(e)
        for tid, evs in threads.items():
            by_line[f"cpu thread {tid}"] = _self_times(evs)
    lines = []
    for name, evs in by_line.items():
        totals = defaultdict(lambda: [0.0, 0])
        for e, us in evs:
            totals[e["name"]][0] += us
            totals[e["name"]][1] += 1
        lo = min(e["ts"] for e, _ in evs)
        hi = max(e["ts"] + e["dur"] for e, _ in evs)
        ops = sorted(((us / 1e3 / iters, c / iters if iters > 1 else c, n)
                      for n, (us, c) in totals.items()), reverse=True)
        lines.append(Line(name, sum(o[0] for o in ops),
                          (hi - lo) / 1e3 / iters, ops))
    lines.sort(key=lambda ln: -ln.busy_ms)
    return Trace(lines, dict(host))


def print_table(trace: Trace, printer=print, top: int = TOP):
    """Root's table: per line its busy time and span per iteration, the
    top `top` ops and the rest as "(other N ops)"."""
    for line in trace.lines:
        printer(f"\n-- line: {line.name!r} ops={len(line.ops)} "
                f"busy={line.busy_ms:.3f} ms/iter "
                f"span={line.span_ms:.3f} ms/iter --")
        for ms, count, name in line.ops[:top]:
            printer(f"  {ms:9.3f} ms/iter  x{count:<7.1f} {name[:95]}")
        rest = line.ops[top:]
        if rest:
            printer(f"  {sum(o[0] for o in rest):9.3f} ms/iter  (other "
                    f"{len(rest)} ops)")


def trace_call(fn, device, logdir=None, cuda_only=False, iters=1):
    """fn() under torch.profiler (utils/profiling.start_trace /
    stop_trace; `cuda_only`: the card's activity alone), between two CUDA
    events on a card.  Returns (read_trace of the written Chrome trace
    per `iters`, the span of fn in ms: CUDA events on a card, the host
    clock on the CPU, either with the profiler on).  Without a `logdir`
    the trace goes to a temporary directory, removed after the read."""
    import torch

    from reduced3dgs_torch.utils import profiling

    own = logdir is None
    logdir = logdir or tempfile.mkdtemp(prefix="r3dgs_trace_")
    cuda = torch.device(device).type == "cuda"
    profiling.start_trace(logdir, cuda_only=cuda_only)
    try:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            span = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn()
            span = (time.perf_counter() - t0) * 1e3
    finally:
        path = profiling.stop_trace()
    try:
        return read_trace(path, iters), span
    finally:
        if own:
            shutil.rmtree(logdir, ignore_errors=True)


def run(width, height, n, budget, iters, smin, smax, device, logdir=None,
        printer=print, grad_reduce=None, top=TOP):
    """The script's body (the table lists `top` ops per line); returns
    the Trace."""
    import torch

    from reduced3dgs_torch.bench import FwdBwd

    grad_reduce = grad_reduce or os.environ.get("R3DGS_GRAD_REDUCE", "f32")
    step = FwdBwd(width, height, n, smin, smax, budget, device, grad_reduce,
                  chained=True)
    runner = step.runner()
    step.carry.zero_()
    runner.replay()
    printer(f"num_rendered={int(runner.out[1])} budget={budget} "
            f"grad_reduce={grad_reduce}")
    step.carry.zero_()
    cuda = torch.device(device).type == "cuda"
    wall = []

    def replays():
        t0 = time.perf_counter()
        for _ in range(iters):
            runner.replay()
        if cuda:
            torch.cuda.synchronize(device)
        wall.append(time.perf_counter() - t0)

    trace, _ = trace_call(replays, device, logdir, iters=iters)
    dt = wall[0]
    printer(f"wall: {dt / iters * 1e3:.2f} ms/iter "
            f"({width * height * iters / dt:,.0f} px/s)")
    print_table(trace, printer, top)
    return trace


def main(argv=None):
    from reduced3dgs_torch.bench import device_name
    from reduced3dgs_torch.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", nargs="*",
                    help="width height n_prims budget iters [smin smax]")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    ap.add_argument("--logdir", default=os.path.join(
        tempfile.gettempdir(), "r3dgs_torch_trace"))
    args = ap.parse_args(argv)
    vals = [int(x) for x in args.sizes[:5]]
    width, height, n, budget, iters = vals + list(DEFAULTS[len(vals):])
    smin, smax = SCALES
    if len(args.sizes) > 5:
        smin, smax = float(args.sizes[5]), float(args.sizes[6])
    dev = resolve(args.device)
    print(device_name(dev), flush=True)
    run(width, height, n, budget, iters, smin, smax, dev, args.logdir,
        printer=lambda s: print(s, flush=True))
    print(f"trace: {os.path.join(args.logdir, 'trace.json')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
