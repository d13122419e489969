"""Small copies of the benchmark's configurations and traffic mixes for
the CPU rehearsals: the same files, at sizes a test run holds."""

from __future__ import annotations

import copy

from splatbench.run import HERE, load_json


def config(name: str, **over):
    cfg = copy.deepcopy(load_json(HERE / "configs" / f"{name}.json"))
    cfg.update(width=64, height=48, train_cameras=6, test_cameras=2,
               primitives=1500, capacity=2048)
    cfg["assumed"]["scale_base"] = 0.03
    cfg["training"]["densification_interval"] = 10
    cfg.update(over)
    return cfg


def traffic(name: str, **over):
    t = copy.deepcopy(load_json(HERE / "traffic" / f"{name}.json"))
    if t["generator"] == "train":
        t.update(first_iteration=15001, last_iteration=15039,
                 surgery_every=10, count_samples=2)
    else:
        t.update(poses=24, settle_every=4, start_budget=4096, check_from=8,
                 check_frames=2, trace_frames=5, count_samples=2)
    t.update(over)
    return t
