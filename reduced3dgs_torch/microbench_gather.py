"""Nanoseconds per row of a B_pad-sized gather against the table's width:
the port's counterpart of root microbench_gather.py.

    python -m reduced3dgs_torch.microbench_gather [--device cpu]
        [--rows P] [--batch B] [--iters ITERS]

A B-row gather from a (P, w) table at bench's 1080p geometry (P =
524288, B = 4 * 2^20), for root's nine (width, type) rows: ITERS gathers
t[(idx + i) % P], each summed into one scalar, captured as one CUDA graph
(root's fori_loop in one launch; eager on the CPU), best of 3 replays.
The tables and indices come from torch.Generators seeded 0 and 1 (root
draws jax.random's bits, which the port cannot): normal floats cast to
the row's type, int32 in [0, 2^30).  Printed per row: the table's MB,
ms per gather and ns per row.
"""

from __future__ import annotations

import argparse
import sys

P = 524288
B = 4 * 1024 * 1024
ITERS = 30
BEST_OF = 3
# (width, dtype name) of root's rows
ROWS = [(9, "float32"), (8, "float32"), (6, "float32"), (5, "int32"),
        (4, "int32"), (3, "int32"), (2, "int32"), (9, "bfloat16"),
        (16, "float32")]


def make_inputs(width, dtype, p, b, device):
    """The (p, width) table of `dtype` (a torch dtype) and the b int32
    indices in [0, p)."""
    import torch

    gen = torch.Generator().manual_seed(0)
    if dtype == torch.int32:
        table = torch.randint(0, 1 << 30, (p, width), generator=gen,
                              dtype=torch.int32)
    else:
        table = torch.randn((p, width), generator=gen).to(dtype)
    idx = torch.randint(0, p, (b,), generator=torch.Generator().manual_seed(
        1), dtype=torch.int32)
    return table.to(device), idx.to(device)


def gather_sums(table, idx, iters):
    """Root's loop body `iters` times: the sum of t[(idx + i) % P] (in
    float32, int32 for an int32 table, then as float32) added into one
    float32 scalar."""
    import torch

    p = table.shape[0]
    acc = torch.float32 if table.dtype != torch.int32 else torch.int32
    s = torch.zeros((), dtype=torch.float32, device=table.device)
    for i in range(iters):
        g = table[(idx + i) % p]
        s = s + g.sum(dtype=acc).to(torch.float32)
    return s


def bench_row(width, dtype, device, p=P, b=B, iters=ITERS,
              best_of=BEST_OF):
    """(seconds per gather, the loop's sum) of one row."""
    from reduced3dgs_torch import graphs

    table, idx = make_inputs(width, dtype, p, b, device)
    run = graphs.runner(lambda: gather_sums(table, idx, iters), device)
    best = min(graphs.time_replays(run, 1, device) for _ in range(best_of))
    return best / iters, float(run.out)


def main(argv=None):
    import torch

    from reduced3dgs_torch.bench import device_name
    from reduced3dgs_torch.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    ap.add_argument("--rows", type=int, default=P, help="table rows P")
    ap.add_argument("--batch", type=int, default=B, help="gathered rows B")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    print(device_name(dev), flush=True)
    print(f"device={dev}  P={args.rows}  B={args.batch}", flush=True)
    for w, name in ROWS:
        dtype = getattr(torch, name)
        per_iter, _ = bench_row(w, dtype, dev, args.rows, args.batch,
                                args.iters)
        row_bytes = w * torch.empty((), dtype=dtype).element_size()
        print(f"w={w:2d} {name:8s} table={args.rows * row_bytes / 1e6:6.1f}"
              f" MB  {per_iter * 1e3:7.2f} ms/gather  "
              f"{per_iter / args.batch * 1e9:5.2f} ns/row", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
