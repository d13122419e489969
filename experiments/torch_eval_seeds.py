#!/usr/bin/env python
"""The port's evaluation over several training seeds, then the three
quality experiments on the first seed's models (PyTorch port, card by
default).

    python3 experiments/torch_eval_seeds.py [--seeds 0 1 2] \
        [--root .eval_run] [--out chiprun_out/eval_seeds] \
        [--iterations 10000] [--size 384] [--ft_iters 2000] \
        [--ab_iters 1200] [--device cpu]

For each training seed S it runs ``python -m
reduced3dgs_torch.compression_eval --train_seed S --root <root>/seed_S``
(the world of --seed 0, vanilla and full trained, the four variants of
each scored), then on seed_<first>: ``half_float_ablation``,
``prune_finetune --fracs 0.15 0.17 --ft_iters ...`` (RESULTS.md's rungs)
and ``grad_reduce_ab <ab_iters>`` (all four arms).  Each run's JSON and
RESULTS.md are copied to --out, and --out/summary.json holds the PSNR
and bytes per seed, configuration and variant, each row's spread over
the seeds (max - min and the sample standard deviation), the headline
delta (full/quantised_half - vanilla/baseline) and the f16-xyz cost
(full/quantised_pack - full/quantised_half) per seed, the card's name
and power limit (nvidia-smi) and the seconds of every stage.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(args, timeout=7200):
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args], cwd=REPO, text=True,
                       capture_output=True, timeout=timeout)
    sys.stdout.write(r.stdout[-3000:])
    if r.returncode:
        sys.stdout.write(r.stderr[-4000:])
        raise SystemExit(f"{args[0]} failed ({r.returncode})")
    return time.perf_counter() - t0


def smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def summarize(per_seed):
    """Rows (config/variant) -> PSNR per seed and its spread."""
    rows = {}
    for seed, res in per_seed.items():
        for cfg, models in res.items():
            for tag, r in models.items():
                rows.setdefault(f"{cfg}/{tag}", {})[seed] = r["psnr"]
    out = {}
    for row, by_seed in rows.items():
        v = np.array(list(by_seed.values()))
        out[row] = {"psnr": by_seed, "mean": float(v.mean()),
                    "spread": float(v.max() - v.min()),
                    "std": float(v.std(ddof=1)) if v.size > 1 else 0.0}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--root", default=os.path.join(REPO, ".eval_run"))
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "eval_seeds"))
    ap.add_argument("--iterations", type=int, default=10_000)
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--ft_iters", type=int, default=2000)
    ap.add_argument("--ab_iters", type=int, default=1200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    card = smi()
    print(card, flush=True)
    dev = ["--device", args.device]
    stages, per_seed, record = {}, {}, {"card": card, "args": vars(args)}
    for seed in args.seeds:
        root = os.path.join(args.root, f"seed_{seed}")
        shutil.rmtree(root, ignore_errors=True)
        stages[f"eval_seed_{seed}_s"] = run(
            ["reduced3dgs_torch.compression_eval", "--root", root,
             "--train_seed", str(seed), "--iterations", str(args.iterations),
             "--size", str(args.size)] + dev)
        with open(os.path.join(root, "results.json")) as f:
            res = json.load(f)
        per_seed[seed] = res["results"]
        record[f"seed_{seed}"] = res
        shutil.copy(os.path.join(root, "RESULTS.md"),
                    os.path.join(args.out, f"RESULTS_seed_{seed}.md"))
    root = os.path.join(args.root, f"seed_{args.seeds[0]}")
    common = ["--root", root] + dev
    it = ["--iterations", str(args.iterations)]
    stages["half_float_ablation_s"] = run(
        ["reduced3dgs_torch.half_float_ablation"] + it + common)
    stages["prune_finetune_s"] = run(
        ["reduced3dgs_torch.prune_finetune", "--fracs", "0.15", "0.17",
         "--ft_iters", str(args.ft_iters)] + it + common)
    stages["grad_reduce_ab_s"] = run(
        ["reduced3dgs_torch.grad_reduce_ab", str(args.ab_iters)] + common)
    for name in ("half_float_ablation", "prune_finetune", "grad_reduce_ab"):
        with open(os.path.join(root, f"{name}.json")) as f:
            record[name] = json.load(f)
    record["summary"] = summarize(per_seed)
    record["headline_db"] = {
        s: r["full"]["quantised_half"]["psnr"]
        - r["vanilla"]["baseline"]["psnr"] for s, r in per_seed.items()}
    record["f16_xyz_cost_db"] = {
        s: r["full"]["quantised_pack"]["psnr"]
        - r["full"]["quantised_half"]["psnr"] for s, r in per_seed.items()}
    record["stages"] = stages
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(record, f, indent=1)
    for row, r in record["summary"].items():
        print(f"{row:<28} " + " ".join(f"{v:.3f}" for v in r["psnr"].values())
              + f"  mean {r['mean']:.3f} spread {r['spread']:.3f}")
    print(json.dumps({"headline_db": record["headline_db"],
                      "f16_xyz_cost_db": record["f16_xyz_cost_db"],
                      "stages": stages, "card": card}))


if __name__ == "__main__":
    main()
