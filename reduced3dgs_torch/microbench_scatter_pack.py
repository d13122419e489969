"""Does one complex64 scatter cost one int32 scatter or two?  The port's
counterpart of experiments/microbench_scatter_pack.py.

    python -m reduced3dgs_torch.microbench_scatter_pack [--device cpu] \\
        [--batch B] [--prims P]

Root's question is about the JAX package's expand step, which scatters
two int32 delta columns at the same P positions into B-sized buffers: if
a complex64 scatter (the two deltas as its real and imaginary parts,
exact in f32 for |v| < 2^24) costs one scatter, packing them halves it.
The port has no such scatter on its path: K1 (csrc/expand.cu) writes
every slot's key directly, and csrc/tile_counts.cu adds the tile counts
in shared memory.  So the rows answer root's question for torch's
scatter on the card.

Root's draws (default_rng(0): P = 2^19 positions in [0, B), B =
5,238,784, then two int32 delta columns in [-1000, 1000)) and its three
rows under its tags, each a zeroed buffer and index_add_ (which adds
duplicate positions as .at[].add does; every position is in range, so
root's mode="drop" drops nothing):

  one s32 scatter    one int32 column;
  two s32 scatters   both int32 columns, two buffers;
  one c64 scatter    both columns as one complex64 column.

index_add_ must take complex64 on the device; where it does not, the row
raises index_add_'s own error (no other formulation is substituted).  Each row
runs through graphs.runner (a CUDA graph on the card, eager on the CPU)
and is timed by graphs.best_window: the best of 3 windows (root: the
best of 3 calls), each of as many back-to-back replays as fill 20 ms.
Root's host read-backs are not copied: they work around the TPU
runtime, and a replayed CUDA graph recomputes every replay, timed by
CUDA events.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from reduced3dgs_torch.microbench_binning import on_device

B = 5238784
P = 1 << 19


def draws(b=B, p=P):
    """Root's arrays, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, b, p).astype(np.int32)
    v1 = rng.integers(-1000, 1000, p).astype(np.int32)
    v2 = rng.integers(-1000, 1000, p).astype(np.int32)
    return dict(pos=pos, v1=v1, v2=v2)


def scatter(b, pos, values):
    """A zeroed (b,) buffer of values' type with values added at pos."""
    import torch

    out = torch.zeros(b, dtype=values.dtype, device=values.device)
    return out.index_add_(0, pos, values)


def rows(d, b):
    """{root's tag: a function of no argument} on the tensors of `d`
    (draws() on the device); each returns root's tuple of buffers."""
    import torch

    pos, v1, v2 = d["pos"], d["v1"], d["v2"]
    return {
        "one s32 scatter ": lambda: (scatter(b, pos, v1),),
        "two s32 scatters": lambda: (scatter(b, pos, v1),
                                     scatter(b, pos, v2)),
        "one c64 scatter ": lambda: (scatter(b, pos, torch.complex(
            v1.to(torch.float32), v2.to(torch.float32))),),
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
    ap.add_argument("--batch", type=int, default=B, help="buffer slots B")
    ap.add_argument("--prims", type=int, default=P,
                    help="scattered positions P")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    log_launches_at_exit("microbench_scatter_pack")
    print(device_name(dev), flush=True)
    print(f"device={dev}  B={args.batch}  P={args.prims}", flush=True)
    d = on_device(draws(args.batch, args.prims), dev)
    for tag, ms, reps, launched in time_rows(rows(d, args.batch), dev):
        print(f"{tag}: {ms:.2f} ms" + row_note(ms, reps, launched),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
