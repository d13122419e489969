"""The benchmark of reduced3dgs_torch on NVIDIA cards.

    python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of BENCHMARK.json (a configuration under a traffic mix) on
the card of the machine it is started on and prints one JSON line last:
`correct`, `attempted`, `failed`, `metrics`, `device`, with --trace 1
`breakdown`, and `checks` (every number that decided `correct`, beside
its limit), which also end standard error.  --trace 0 reports the cell's
end-to-end metrics, --trace 1 its per-layer metrics.

Everything is found by name: the configuration's file from
BENCHMARK.json, the traffic mix `traffic/<name>.json` (its "generator"
names the general generator `generators/<generator>.py`), the limits of the cell
`limits/<cell>.json` and each per-layer metric's reader
`layer_metrics/<metric>.py`.  Without a card, or with fewer cards than
the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reduced3dgs_tpu")
_IMPORTED_AT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_IMPORT = process_age()


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    base = CHECKOUT / ".splatbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json and the files it names."""

    def __init__(self, root: Path = CHECKOUT):
        self.root = root
        self.spec = load_json(root / "BENCHMARK.json")

    def cell(self, name):
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell):
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {cell['config']!r}")

    def traffic(self, cell):
        return load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell):
        return load_json(HERE / "limits" / f"{cell['name']}.json")

    @staticmethod
    def _listed(metric, cell):
        return "workloads" not in metric or cell["name"] in metric["workloads"]

    def end_to_end(self, cell):
        return [m for m in self.spec["end_to_end"] if self._listed(m, cell)]

    def per_layer(self, cell):
        """The per-layer metrics this cell reports: listed for it, or
        unlisted and moving an end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def layer_reader(name: str):
    """The `read(record, trace)` of layer_metrics/<name>.py."""
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "splatbench_layer_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def measure(bench: Bench, cell, seed: int, seconds: float, trace: bool,
            device, cfg=None, traffic=None):
    """The generator's Outcome of one run of `cell` (cfg / traffic: in place
    of the files', for rehearsals at small sizes)."""
    cfg = cfg or bench.config(cell)
    traffic = traffic or bench.traffic(cell)
    gen = importlib.import_module(
        f"splatbench.generators.{traffic['generator']}")
    return gen.measure(cfg, traffic, seed, seconds, trace, device)


def result_line(bench: Bench, cell, out, limits, trace: bool, setup_s,
                device_desc):
    """The result's JSON object and the check lines."""
    from splatbench import judge

    correct, rows = judge.verdict(out.numbers, limits)
    metrics = {}
    if not trace:
        values = dict(out.e2e, setup_s=setup_s)
        for m in bench.end_to_end(cell):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in bench.per_layer(cell):
            v = layer_reader(m["name"])(out.record, out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = dict(device_desc, memory_peak_bytes=int(out.memory_peak))
    line = {"correct": bool(correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_ops,
                             "idle_gaps": out.trace.idle_gaps}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    checks = [f"check {n} {v!r} limit {lim!r}" for n, v, lim in rows]
    return line, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    # one host thread: idle intra-op workers spinning beside the loop that
    # feeds the card would make the host's pace, and the window, vary
    os.environ["OMP_NUM_THREADS"] = "1"
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"splatbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    limits = bench.limits(cell)
    out = measure(bench, cell, args.seed, args.seconds, bool(args.trace),
                  device)
    setup_s = _AGE_AT_IMPORT + (out.window_start - _IMPORTED_AT)
    desc = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell["chips"]}
    line, checks = result_line(bench, cell, out, limits, bool(args.trace),
                               setup_s, desc)
    found = forbidden_modules()
    if found:
        print(f"splatbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for note in out.notes:
        print(note, file=sys.stderr)
    print(f"setup_s {setup_s!r}", file=sys.stderr)
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
