"""How the reduction sort's cost grows with the row count: the port's
counterpart of experiments/microbench_sortscale.py.

    python -m reduced3dgs_torch.microbench_sortscale [--device cpu] \\
        [--sizes B ...] [--prims P]

If the sort's cost grows faster than linearly, splitting the
per-primitive reduction sort into independent tile-row-strip sorts wins
the log factor; if linearly, strips are pointless.  At each of root's
five sizes (B = 139,264 ... 2,228,224) it draws root's arrays
(default_rng(0): an int32 key in [0, 2^17), then (9, B) f32 columns),
times root's multi-payload sort (microbench_sort's row a: torch.sort of
the key with its indices, each column gathered by them, summed) and,
beside it, the port's current formulation (microbench_sort's
port_current row: the stable key sort, the bounds, K5), and prints one
JSON line with root's keys ("b", "ncols", "ms"), "port_current_ms" and
the replays per window of each.

Each formulation runs through graphs.runner (a CUDA graph on the card,
eager on the CPU) and is timed by graphs.best_window (the best of 3
windows of back-to-back replays filling 20 ms).  Root runs every size in
a child process because a remote compile service hung on large programs;
the card has no such service, so all sizes run in this one process.
Root's chain(l, x) salting and host read-backs are not copied: a
replayed CUDA graph recomputes every replay, timed by CUDA events.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from reduced3dgs_torch.microbench_binning import on_device
from reduced3dgs_torch.microbench_sort import key_sort_k5, multi_payload_sum

SIZES = (139264, 278528, 557056, 1114112, 2228224)
P = 1 << 17
NCOLS = 9


def draws(b, p=P, ncols=NCOLS):
    """Root's child's arrays, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, p, b, dtype=np.int32)
    cols = rng.normal(0, 1, (ncols, b)).astype(np.float32)
    return dict(key=key, cols=cols)


def rows(d, p):
    """{"ms": root's multi-payload sort, "port_current_ms": the port's key
    sort + K5}, each a function of no argument on the tensors of `d`."""
    from reduced3dgs_torch.ops.tile_render import as_records

    key, cols = d["key"], d["cols"]
    records = as_records(cols)
    return {"ms": lambda: multi_payload_sum(key, list(cols)),
            "port_current_ms": lambda: key_sort_k5(key, records, p)}


def size_line(b, device, p=P):
    """One size's JSON line (a dict)."""
    from reduced3dgs_torch.graphs import time_rows

    line = {"b": b, "ncols": NCOLS}
    for name, ms, reps, _ in time_rows(
            rows(on_device(draws(b, p), device), p), device):
        line[name] = ms
        line[name.replace("ms", "replays")] = reps
    return line


def main(argv=None):
    from reduced3dgs_torch.bench import device_name
    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import log_launches_at_exit

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES),
                    help="row counts B")
    ap.add_argument("--prims", type=int, default=P,
                    help="key range (primitives P)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    log_launches_at_exit("microbench_sortscale")
    print(device_name(dev), flush=True)
    for b in args.sizes:
        print(json.dumps(size_line(b, dev, args.prims)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
