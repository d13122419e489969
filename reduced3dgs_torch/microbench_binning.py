"""Binning's ingredients timed one by one at its sizes: the port's
counterpart of root microbench_binning.py.

    python -m reduced3dgs_torch.microbench_binning [--device cpu]
        [--batch B] [--prims P]

Root's draws (default_rng(0): tile, dkey, gid, pad over B = 2^20 slots,
rows5 over P = 2^17 primitives, f32) and its 14 rows under their names,
each the torch call that computes what the JAX row computes, run through
graphs.runner (a CUDA graph on the card, eager on the CPU) and timed as
the mean of REPS calls.  Two-key sorts become one int64 key tile << 32 |
key with the payloads gathered by the permutation; assoc_scan_max is
torch.cummax; cumsum keeps int32; argsort is stable, as jnp.argsort is.

Not repeated from the reference: its sort64key row builds the key as
tile.astype(int64) << 32 | dkey, which without jax_enable_x64 stays int32,
so its key equals dkey; the port sorts the real int64 key (and says so).
The searchsorted rows search the unsorted dkey as root's do, so their
answers depend on the search's implementation; only their times compare.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

B = 1 << 20
P = 1 << 17
REPS = 20
NOTE = ("sort64key+2pay_1M sorts the int64 key tile << 32 | dkey; root's "
        "row sorts dkey itself (without jax_enable_x64 its "
        "tile.astype(int64) << 32 stays int32)")


def draws(b=B, p=P):
    """Root's arrays, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    return dict(
        tile=rng.integers(0, 1024, b).astype(np.int32),
        dkey=rng.integers(0, 2 ** 30, b).astype(np.int32),
        gid=rng.integers(0, p, b).astype(np.int32),
        pad=rng.integers(0, 2, b).astype(np.int32),
        rows5=rng.normal(size=(p, 5)).astype(np.float32),
        f32=rng.normal(size=b).astype(np.float32))


def _sorted_by(key, *payloads):
    """A stable sort of `key` and the payloads gathered by its
    permutation: lax.sort's operands, sorted."""
    import torch

    values, perm = torch.sort(key, stable=True)
    return (values,) + tuple(x[perm] for x in payloads)


def rows(d):
    """{row name: a function of no argument} on the tensors of `d`
    (draws() on the device).  Each returns what the JAX row computes, the
    sorts all their sorted operands (root's rows keep the first)."""
    import torch

    tile, dkey, gid, pad = d["tile"], d["dkey"], d["gid"], d["pad"]
    b, p = tile.shape[0], d["rows5"].shape[0]
    key2 = (tile.to(torch.int64) << 32) | dkey.to(torch.int64)
    ar = torch.arange(1024, dtype=torch.int32, device=tile.device)
    slots = torch.arange(b, dtype=torch.int32, device=tile.device) % p

    def two_keys(*payloads):
        values, *rest = _sorted_by(key2, *payloads)
        return ((values >> 32).to(torch.int32),
                values.to(torch.int32)) + tuple(rest)

    return {
        "sort1key_1M": lambda: torch.sort(dkey).values,
        "sort1key_stable_1M": lambda: torch.sort(dkey, stable=True).values,
        "sort2key+1pay_1M": lambda: two_keys(gid),
        "sort2key+2pay_1M": lambda: two_keys(gid, pad),
        "sort1key+2pay_1M": lambda: _sorted_by(dkey, gid, pad),
        "sort64key+2pay_1M": lambda: _sorted_by(key2, gid, pad),
        "argsort_1M": lambda: torch.argsort(dkey, stable=True),
        "rowgather_1M_x5": lambda: d["rows5"][gid],
        "gather1d_1M": lambda: d["f32"][gid % b],
        "scatter_max_P": lambda: torch.zeros(
            b, dtype=torch.int32, device=tile.device).scatter_reduce(
            0, gid.long(), slots, reduce="amax"),
        "assoc_scan_max_1M": lambda: torch.cummax(tile, 0).values,
        "cumsum_1M": lambda: torch.cumsum(tile, 0, dtype=torch.int32),
        "searchsorted_1k_in_1M": lambda: torch.searchsorted(
            dkey, ar, out_int32=True),
        "searchsorted_1M_in_1k": lambda: torch.searchsorted(
            ar, tile, out_int32=True),
    }


def on_device(d, device):
    import torch

    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def time_rows(device, b=B, p=P, printer=print):
    """Every row's mean ms per call; printed as root prints them."""
    from reduced3dgs_torch import graphs

    d = on_device(draws(b, p), device)
    out = {}
    for name, fn in rows(d).items():
        run = graphs.runner(fn, device)
        out[name] = graphs.time_replays(run, REPS, device) / REPS * 1e3
        printer(f"{name:28s} {out[name]:8.3f} ms")
        del run
    return out


def main(argv=None):
    from reduced3dgs_torch.bench import device_name
    from reduced3dgs_torch.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    ap.add_argument("--batch", type=int, default=B, help="slots B")
    ap.add_argument("--prims", type=int, default=P, help="primitives P")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    print(device_name(dev), flush=True)
    print(f"device={dev}  B={args.batch}  P={args.prims}", flush=True)
    print(NOTE, flush=True)
    time_rows(dev, args.batch, args.prims,
              printer=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
