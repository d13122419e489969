"""Readings that the limits of the `compress` traffic's `correct` are set
from (not run by the benchmark's own runs; splatbench.calibrate drives
the train and view traffics):

    python3 -m splatbench.calibrate_compress --seeds <n> ... \\
        [--control <k>] [--faults <f>] [--seconds <s>]

For every seed, one run of m360_full.compress (set-up, the first cycle
with its checks, a window of --seconds, the reference) prints the
program's numbers.  For the first k seeds it also prints the control's:
each check's reference computed in bfloat16 in the program's place,
against the float32 reference (the dead-prune's rule, the kNN, mercy's
decision on the program's lists, the transmittance sums, the cull's two
passes on the program's per-camera sums, the training iterations after
the compression).  For the first f seeds, one run each with a fault
planted in the program (--fault-names, all by default): mercy skipped,
the cull's passes skipped (its renders kept), the variance pass's
weighted mean left out of the DC term (its degrees kept), a stale
snapshot (the cycles restore the state after the first cycle).  One
JSON line each, on the card of the machine it runs on.
"""

from __future__ import annotations

import argparse
import json
from contextlib import contextmanager

import torch

from splatbench import judge
from splatbench.run import HERE, load_json

CELL = "m360_full.compress"


def control_numbers(prog, cfg, traffic, seed, device, opt):
    """The control's numbers from a run's first-cycle readings (run with
    the cull's reference also in bfloat16)."""
    from splatbench.generators import compress as gen

    low = torch.bfloat16
    before, opacity, _ = prog["prune"]
    want = before & ~(torch.sigmoid(opacity) < 1.0 / 255.0)
    numbers = {"prune_mismatches": judge.prune_mismatches(
        (before, opacity.to(low).float(), want))}
    points, lists = prog["knn"]
    numbers["knn_mismatches"], _ = gen.knn_mismatches(points, lists, seed,
                                                      device, low)
    mercy_before, _ = prog["mercy"]
    want, _ = gen.mercy_decision(mercy_before, lists, cfg, seed, opt,
                                 device)
    got, _ = gen.mercy_decision(mercy_before, lists, cfg, seed, opt, device,
                                low)
    numbers["mercy_mismatches"] = int((got != want).sum())
    cull = prog["cull"]
    numbers["trans_gap"] = max(cull.control_gaps)
    numbers["cull_degree_mismatches"] = int(
        (cull.results[low][1] != cull.results[torch.float32][1]).sum())
    numbers["feature_gap"] = gen.coefficient_gap(
        *cull.results[low], *cull.results[torch.float32],
        prog["post"]["alive"])
    base = gen.train_readings(cfg, traffic, seed, prog["post"], device)
    lower = gen.train_readings(cfg, traffic, seed, prog["post"], device,
                               low)
    numbers.update(judge.train_numbers(lower, base))
    return numbers


@contextmanager
def fault(name):
    """The program with `name` planted in it inside the block."""
    from reduced3dgs_torch.ops import sh_culling
    from reduced3dgs_torch.train import trainer as T
    from splatbench.generators import compress as gen

    if name == "mercy_skipped":
        def skipped(state, counts, **kw):
            zero = torch.zeros((), device=counts.device)
            return state, {"n_points_mercied": zero.long(),
                           "redundancy_threshold": zero,
                           "opacity_threshold": zero}
        patches = [(T, "mercy_step", skipped)]
    elif name == "dc_mean_skipped":  # degrees right, DC term kept
        real_v = sh_culling.low_variance_colour_culling

        def kept_dc(pool, *a, **kw):
            out, n = real_v(pool, *a, **kw)
            return out.replace(params=out.params._replace(
                features_dc=pool.params.features_dc)), n
        patches = [(sh_culling, "low_variance_colour_culling", kept_dc)]
    elif name == "cull_skipped":
        patches = [(sh_culling, "low_variance_colour_culling",
                    lambda pool, *a, **kw: (pool, 0)),
                   (sh_culling, "low_distance_colour_culling",
                    lambda pool, *a, **kw: pool)]
    else:  # stale_snapshot
        real = gen.Compress.check_cycle

        def stale(self, *a, **kw):
            out = real(self, *a, **kw)
            self.snap = gen.snapshot(self.trainer)
            return out
        patches = [(gen.Compress, "check_cycle", stale)]
    saved = [(o, n, getattr(o, n)) for o, n, _ in patches]
    for o, n, f in patches:
        setattr(o, n, f)
    try:
        yield
    finally:
        for o, n, f in saved:
            setattr(o, n, f)


FAULTS = ("mercy_skipped", "cull_skipped", "dc_mean_skipped",
          "stale_snapshot")


def main(argv=None):
    from splatbench import run
    from splatbench.generators import compress as gen
    from splatbench.reference import full_precision

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault-names", nargs="+", choices=FAULTS,
                    default=list(FAULTS))
    args = ap.parse_args(argv)
    run.cache_dirs()
    bench = run.Bench()
    cell = bench.cell(CELL)
    cfg, traffic = bench.config(cell), bench.traffic(cell)
    dev = torch.device("cuda", 0)
    for j, seed in enumerate(args.seeds):
        dtypes = ((torch.float32, torch.bfloat16) if j < args.control
                  else (torch.float32,))
        out, prog, opt = gen.run(cfg, traffic, seed, args.seconds, False,
                                 dev, dtypes)
        print(json.dumps({"seed": seed, "kind": "program",
                          "numbers": out.numbers, "e2e": out.e2e,
                          "notes": out.notes}), flush=True)
        if j < args.control:
            with full_precision():
                nums = control_numbers(prog, cfg, traffic, seed, dev, opt)
            print(json.dumps({"seed": seed, "kind": "control",
                              "numbers": nums}), flush=True)
        del out, prog
        torch.cuda.empty_cache()
        if j < args.faults:
            for name in args.fault_names:
                with fault(name):
                    got = gen.measure(cfg, traffic, seed, args.seconds,
                                      False, dev)
                print(json.dumps({"seed": seed, "kind": f"fault:{name}",
                                  "numbers": got.numbers}), flush=True)
                del got
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
