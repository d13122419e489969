"""The reduction tail after the sort, formulated five ways, and the port's
K5 in its place: the port's counterpart of
experiments/microbench_reduce.py.

    python -m reduced3dgs_torch.microbench_reduce [--device cpu] \\
        [--batch B] [--prims P]

Root's draws (default_rng(0): (9, B) f32 columns over B = 2,228,224
slots, then P + 1 sorted int32 segment bounds in [0, B), P = 2^17, then
an int32 key in [0, P)) and its five rows under their names, each
returning the sum root's body returns:

  a_9cumsum_rowgather  nine (B,) cumsums behind a zero, stacked to
                       (B + 1, 9), the rows at the bounds, their diffs;
  b_1cumsum_take1      one (9, B) cumsum behind a zero column, the columns
                       at the bounds, their diffs;
  c_1cumsum_take2      one inclusive (9, B) cumsum, two column picks;
  d_one_big_sort       the key sorted with the nine columns as payloads
                       (torch.sort with its indices and each column
                       gathered, as microbench_sort's row a);
  e_17_strip_sorts     the same as 17 sorts of B // 17 slots each.

One more row, port_current_K5, is the tail that replaced the cumsums in
the port: K5 (csrc/seg_reduce.cu) on the same columns held as K3's
slot-major records, over the same bounds, the order the identity; it
returns the (9, P) sums and launches K5 once.

Every row runs through graphs.runner (a CUDA graph on the card, eager on
the CPU) and is timed by graphs.best_window: the best of 3 windows, each
of as many back-to-back replays as fill 20 ms (printed per row).  Root's
chain(l, x) salting and its host read-backs are not copied: they work
around XLA's caching and the TPU runtime, and a replayed CUDA graph
recomputes every replay, timed by CUDA events.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from reduced3dgs_torch.microbench_binning import on_device
from reduced3dgs_torch.microbench_sort import multi_payload_sum, root_line

B = 2228224
P = 1 << 17
STRIPS = 17


def draws(b=B, p=P):
    """Root's arrays, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    cols = rng.normal(0, 1, (9, b)).astype(np.float32)
    zb = np.sort(rng.integers(0, b, p + 1)).astype(np.int32)
    key = rng.integers(0, p, b, dtype=np.int32)
    return dict(cols=cols, zb=zb, key=key)


def rows(d):
    """{row name: a function of no argument} on the tensors of `d`
    (draws() on the device); each returns what the JAX row computes, the
    port's row its (9, P) sums."""
    import torch

    from reduced3dgs_torch.ops import tile_render as ttr

    cols, zb, key = d["cols"], d["zb"], d["key"]
    b = cols.shape[1]
    dev = cols.device
    bs = b // STRIPS
    records = ttr.as_records(cols)
    identity = torch.arange(b, device=dev)

    def zero_first(ps, dim):
        shape = list(ps.shape)
        shape[dim] = 1
        return torch.cat([torch.zeros(shape, device=dev), ps], dim=dim)

    def body_a():
        ps = torch.stack([zero_first(torch.cumsum(c, 0), 0) for c in cols],
                         dim=1)  # (B + 1, 9)
        v = ps.index_select(0, zb)
        return (v[1:] - v[:-1]).sum()

    def body_b():
        ps = zero_first(torch.cumsum(cols, 1), 1)  # (9, B + 1)
        v = ps.index_select(1, zb)
        return (v[:, 1:] - v[:, :-1]).sum()

    def body_c():
        ps = torch.cumsum(cols, 1)  # inclusive
        hi = ps.index_select(1, torch.clamp(zb[1:] - 1, min=0))
        lo = ps.index_select(1, torch.clamp(zb[:-1] - 1, min=0))
        return (torch.where(zb[1:] > 0, hi, 0.0)
                - torch.where(zb[:-1] > 0, lo, 0.0)).sum()

    def body_e():
        tot = torch.zeros((), device=dev)
        for s in range(STRIPS):
            sl = slice(s * bs, (s + 1) * bs)
            tot = tot + multi_payload_sum(key[sl], [c[sl] for c in cols])
        return tot

    return {
        "a_9cumsum_rowgather": body_a,
        "b_1cumsum_take1": body_b,
        "c_1cumsum_take2": body_c,
        "d_one_big_sort": lambda: multi_payload_sum(key, list(cols)),
        "e_17_strip_sorts": body_e,
        "port_current_K5": lambda: ttr.seg_reduce(records, identity, zb,
                                                  packed=False),
    }


def main(argv=None):
    from reduced3dgs_torch.bench import device_name
    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import (
        log_launches_at_exit, row_note, time_rows,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    ap.add_argument("--batch", type=int, default=B, help="slots B")
    ap.add_argument("--prims", type=int, default=P, help="primitives P")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    log_launches_at_exit("microbench_reduce")
    print(device_name(dev), flush=True)
    print(f"device={dev}  B={args.batch}  P={args.prims}", flush=True)
    d = on_device(draws(args.batch, args.prims), dev)
    for name, ms, reps, launched in time_rows(rows(d), dev):
        print(root_line(name, ms) + row_note(ms, reps, launched),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
