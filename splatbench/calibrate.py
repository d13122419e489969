"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs):

    python3 -m splatbench.calibrate --config <name or .json path> \\
        --traffic <name> --seeds <n> ... [--control <k>] [--seconds <s>]

For every seed, one run of the cell (set-up, a window of --seconds, the
comparison with the reference) prints the program's numbers.  For the
first k seeds it also prints the control's (the reference computed in
bfloat16 put in the program's place, against the float32 reference) and
the planted faults' (training: the image loss over half of the image's
rows; viewing: the frame of the previous pose, the lower half of the
frame left black, a 32x32 block of the frame altered by 0.5).  One JSON
line each, on the card of the machine it runs on.
"""

from __future__ import annotations

import argparse
import json

import torch

from splatbench import judge
from splatbench.run import HERE, load_json

FAULT_BLOCK = 32


def _train_readings(cfg, traffic, seed, dev):
    from splatbench.generators import train as tr

    base = tr.reference_readings(cfg, traffic, seed, dev)
    low = tr.reference_readings(cfg, traffic, seed, dev, torch.bfloat16)
    half = tr.reference_readings(cfg, traffic, seed, dev,
                                 rows=cfg["height"] // 2)
    return {"control": judge.train_numbers(low, base),
            "fault:half_batch": judge.train_numbers(half, base)}


def _view_readings(cfg, traffic, seed, dev):
    from splatbench import scene
    from splatbench.generators import view as vw

    poses = scene.viewing_path(cfg, seed, traffic["poses"])
    picks = [1, traffic["check_from"] // 2]
    model = vw.reference_model(cfg, seed, dev)
    base = {i: vw.reference_frame(cfg, model, poses[i], dev)[0]
            for i in picks}
    prev = {i: vw.reference_frame(cfg, model, poses[i - 1], dev)[0]
            for i in picks}
    del model
    low_model = vw.reference_model(cfg, seed, dev, torch.bfloat16)
    low = {i: vw.reference_frame(cfg, low_model, poses[i], dev,
                                 torch.bfloat16)[0].float() for i in picks}
    del low_model
    half = {i: base[i].clone() for i in picks}
    block = {i: base[i].clone() for i in picks}
    for i in picks:
        half[i][cfg["height"] // 2:] = 0.0
        block[i][:FAULT_BLOCK, :FAULT_BLOCK] += 0.5
    return {"control": judge.frame_numbers(low, base),
            "fault:stale_frame": judge.frame_numbers(prev, base),
            "fault:half_frame": judge.frame_numbers(half, base),
            "fault:altered_block": judge.frame_numbers(block, base)}


def main(argv=None):
    from splatbench import run
    from splatbench.reference import full_precision

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    run.cache_dirs()
    cfg = load_json(args.config if args.config.endswith(".json")
                    else HERE / "configs" / f"{args.config}.json")
    traffic = load_json(HERE / "traffic" / f"{args.traffic}.json")
    dev = torch.device("cuda", 0)
    bench = run.Bench()
    cell = {"name": f"{cfg['name']}.{args.traffic}", "chips": 1}
    for j, seed in enumerate(args.seeds):
        out = run.measure(bench, cell, seed, args.seconds, False, dev,
                          cfg=cfg, traffic=traffic)
        print(json.dumps({"seed": seed, "kind": "program",
                          "numbers": out.numbers, "e2e": out.e2e,
                          "notes": out.notes}), flush=True)
        del out
        if j < args.control:
            readings = (_train_readings if traffic["generator"] == "train"
                        else _view_readings)
            with full_precision():
                for kind, nums in readings(cfg, traffic, seed, dev).items():
                    print(json.dumps({"seed": seed, "kind": kind,
                                      "numbers": nums}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
