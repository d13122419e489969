"""The backward's per-primitive reduction sort, formulated four ways, and
the port's own key sort + K5: the port's counterpart of
experiments/microbench_sort.py.

    python -m reduced3dgs_torch.microbench_sort [--device cpu] \\
        [--batch B] [--prims P]

Root's draws (default_rng(0): an int32 key in [0, P) over B = 2,228,224
slots, P = 2^17, then a (B, 16) f32 column matrix) and its four rows
under their names, each returning the sum root's body returns:

  a_multi_payload_sort   the key sorted with the nine columns as payloads.
                         torch has no sort with several payloads, so the
                         row is torch.sort of the key with its indices and
                         then each column gathered by them: on the card
                         row a is row b written out column by column;
  b_perm_sort+gather9    the permutation sort and one (B, 9) row gather;
  c_perm_sort+gather16   the same with a (B, 16) row gather;
  d_key_only_sort        the key alone (its int32 sum, as root's).

One more row, port_current_key_sort+K5, times what the port's backward
does today (ops/tile_render.py: segment_order's stable key sort, then
K5, csrc/seg_reduce.cu, on a (9, B) f32 payload held as K3's slot-major
records) with the segment bounds searched in the sorted keys; it returns
the (9, P) sums and launches K5 once.  It is the port's formulation at
root's sizes, not the port's step: the backward takes the bounds from
binning (seg_bounds, no search), and its key, where(pad, P, depth rank),
runs over 1080p's B_pad (~4.2M slots, P = 2^19) with pad slots.

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

B = 2228224
P = 1 << 17
NCOLS = 9  # gradient columns the reduction carries


def draws(b=B, p=P):
    """Root's arrays, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    return dict(key=rng.integers(0, p, b, dtype=np.int32),
                cols=rng.normal(0, 1, (b, 16)).astype(np.float32))


def multi_payload_sum(key, payloads):
    """lax.sort((key,) + payloads, num_keys=1) summed payload by payload,
    as root's bodies sum it: torch.sort of the key (unstable, as root's
    is_stable=False) and each payload gathered by its permutation."""
    import torch

    perm = torch.sort(key).indices
    return sum(c[perm].sum() for c in payloads)


def key_sort_bounds(key, p):
    """segment_order's stable sort of a key in [0, p) and the p + 1
    segment bounds searched in the sorted keys: (order, bounds), K5's
    inputs besides the payload."""
    import torch

    values, order = torch.sort(key, stable=True)
    ids = torch.arange(p + 1, dtype=key.dtype, device=key.device)
    return order, torch.searchsorted(values, ids, out_int32=True)


def key_sort_k5(key, records, p):
    """The port's reduction on a key in [0, p): key_sort_bounds and K5
    (tile_render.seg_reduce) on `records` (as_records' (9, B) view): the
    (9, p) f32 sums in key order."""
    from reduced3dgs_torch.ops import tile_render as ttr

    return ttr.seg_reduce(records, *key_sort_bounds(key, p), packed=False)


def rows(d, p):
    """{row name: a function of no argument} on the tensors of `d`
    (draws() on the device); each returns what the JAX row computes, the
    port's row its (9, p) sums."""
    import torch

    from reduced3dgs_torch.ops.tile_render import as_records

    key, cols = d["key"], d["cols"]
    records = as_records(cols[:, :NCOLS].T)
    return {
        "a_multi_payload_sort": lambda: multi_payload_sum(
            key, [cols[:, i] for i in range(NCOLS)]),
        "b_perm_sort+gather9": lambda: cols[:, :NCOLS][
            torch.sort(key).indices].sum(),
        "c_perm_sort+gather16": lambda: cols[
            torch.sort(key).indices][:, :NCOLS].sum(),
        "d_key_only_sort": lambda: torch.sort(key).values.sum(
            dtype=torch.int32).to(torch.float32),
        "port_current_key_sort+K5": lambda: key_sort_k5(key, records, p),
    }


def root_line(name, ms):
    """Root's line of a row."""
    return f"{name:24s} {ms:8.2f} ms"


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
    log_launches_at_exit("microbench_sort")
    print(device_name(dev), flush=True)
    print(f"device={dev}  B={args.batch}  P={args.prims}", flush=True)
    d = on_device(draws(args.batch, args.prims), dev)
    for name, ms, reps, launched in time_rows(rows(d, args.prims), dev):
        print(root_line(name, ms) + row_note(ms, reps, launched),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
