#!/usr/bin/env python3
"""The training step of two or more trees of this repository, timed in
turns on one card.

    python3 experiments/torch_step_interleave.py TREE [TREE ...]
        [--rounds N] [--alternate] [--seed S]

Host-bound times (the median Trainer.step, fwd+bwd) move by 10-20 % with
the machine's other load, so one run per tree cannot order two trees.
Each TREE is an unpacked commit with chip_smoke.py at its root.  In every
round each tree, in the order given (--alternate: reversed in every
second round, so that no tree always follows the other), gets a process
of its own that runs
only phase 9 of that tree's chip_smoke.py (fwd_bwd_rate, then
train_main_path: 24 bf16x2 steps, 4 steps with stage marks, one profiled
step, 4 f32 steps) with nothing of the other phases before it; the kernels
build at first use in the first round.  Per run one line: fwd+bwd ms, the
median bf16x2 and f32 step, the stage sum, the profiled step's kernel time
and launches; at the end every tree's runs side by side and their medians.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys

PHASE9 = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda")
smi = cs.smi_line()
pps, ms, nr = cs.fwd_bwd_rate(dev, {seed})
print(f"phase 9: fwd+bwd {{ms:.3f}} ms", flush=True)
cs.train_main_path(dev, {seed}, smi)
"""
READINGS = {
    "fwd_bwd_ms": r"phase 9: fwd\+bwd ([\d.]+) ms",
    "step_ms": r"bf16x2 steps at .*?median step ([\d.]+) ms",
    "f32_step_ms": r"f32 steps: .*?median step ([\d.]+) ms",
    "stage_sum_ms": r"stage ms per step .*?sum ([\d.]+) ms",
    "kernel_ms": r"kernel launches and ([\d.]+) ms of kernel time",
    "launches": r"profiled step: (\d+) kernel launches",
}


def run_tree(tree, seed):
    r = subprocess.run([sys.executable, "-c", PHASE9.format(seed=seed)],
                       cwd=tree, capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: phase 9 failed\n{r.stdout[-2000:]}\n"
                           f"{r.stderr[-4000:]}")
    got = {}
    for name, pat in READINGS.items():
        m = re.search(pat, r.stdout)
        if m is None:
            raise RuntimeError(f"{tree}: no {name} in\n{r.stdout[-4000:]}")
        got[name] = float(m.group(1))
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--alternate", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    runs = {t: [] for t in args.trees}
    for rnd in range(args.rounds):
        order = args.trees[::-1] if args.alternate and rnd % 2 \
            else args.trees
        for tree in order:
            got = run_tree(tree, args.seed)
            runs[tree].append(got)
            print(f"round {rnd} {tree}: "
                  + ", ".join(f"{k} {v:g}" for k, v in got.items())
                  + f"; {smi}", flush=True)
    for name in READINGS:
        for tree in args.trees:
            vals = [r[name] for r in runs[tree]]
            print(f"{name} {tree}: {', '.join(f'{v:g}' for v in vals)}; "
                  f"median {statistics.median(vals):g}; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
