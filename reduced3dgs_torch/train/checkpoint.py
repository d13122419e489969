"""Checkpoints: the whole TrainState in one .npz (numpy and torch only).

Counterpart of reduced3dgs_tpu/train/checkpoint.py, in the same layout,
so that a checkpoint written by either package loads in the other:

  leaf_0 .. leaf_5    the six parameter leaves (xyz, features_dc,
                      features_rest, scaling, rotation, opacity)
  leaf_6 .. leaf_11   degrees (int32), alive (bool), max_radii2d,
                      xyz_grad_accum, denom, active_sh_degree (() int32)
  leaf_12 .. leaf_17  Adam's first moments, leaf_18 .. leaf_23 its second
                      moments, leaf_24 .. leaf_29 its per-leaf step
                      counts (() int32)
  leaf_30             the random key, uint32[2]
  iteration           int64;  spatial_lr_scale  float64

The JAX package's key is a PRNG key.  The port keeps a torch.Generator
instead: it writes the generator's seed as the key's two 32-bit words
(high, low) and re-seeds a generator from them on load.  So the random
draws after a resume (densification's split noise) are the port's own,
as they are before one; they match neither an unbroken run's nor the JAX
package's.  A file of the older layout with one scalar Adam step
(26 leaves) loads with that step on every leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from reduced3dgs_torch.device import resolve
from reduced3dgs_torch.models.gaussians import GaussianParams, GaussianPool
from reduced3dgs_torch.train.adam import AdamState
from reduced3dgs_torch.train.trainer import TrainState

_NP = len(GaussianParams._fields)
_POOL_LEAVES = ("degrees", "alive", "max_radii2d", "xyz_grad_accum",
                "denom")
_LEAVES = 2 * _NP + 3 * _NP + 1  # pool (with active_sh_degree), Adam, key
_LEGACY_LEAVES = 2 * _NP + 2 * _NP + 2  # one scalar step


def _np(t):
    return t.detach().cpu().numpy()


def state_leaves(state: TrainState) -> list:
    """The TrainState as numpy arrays in the JAX package's pytree order."""
    pool, opt, gen = state
    seed = gen.initial_seed() if gen is not None else 0
    leaves = [_np(p) for p in pool.params]
    leaves += [_np(getattr(pool, k)) for k in _POOL_LEAVES]
    leaves.append(np.int32(pool.active_sh_degree))
    leaves += [_np(m) for m in opt.mu] + [_np(v) for v in opt.nu]
    leaves += [np.int32(t) for t in opt.step]
    leaves.append(np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32))
    return leaves


def save_checkpoint(path, state: TrainState, iteration: int,
                    spatial_lr_scale: float):
    arrays = {f"leaf_{i}": np.asarray(x)
              for i, x in enumerate(state_leaves(state))}
    arrays["iteration"] = np.int64(iteration)
    arrays["spatial_lr_scale"] = np.float64(spatial_lr_scale)
    np.savez(path, **arrays)


def load_checkpoint(path, device=None):
    """Returns (state, iteration, spatial_lr_scale), the state's tensors
    on `device` (default: the card)."""
    dev = resolve(device)
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        iteration = int(data["iteration"])
        slr = float(data["spatial_lr_scale"])
    if n == _LEGACY_LEAVES:
        leaves = leaves[:4 * _NP] + [leaves[4 * _NP]] * _NP + leaves[-1:]
    elif n != _LEAVES:
        raise ValueError(f"{path}: {n} leaves, expected {_LEAVES} (or "
                         f"{_LEGACY_LEAVES} in the scalar-step layout)")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    params = GaussianParams(*(t(a) for a in leaves[:_NP]))
    rest = leaves[_NP:]
    pool = GaussianPool(
        params=params,
        **{k: t(a) for k, a in zip(_POOL_LEAVES, rest[:5])},
        active_sh_degree=int(rest[5]))
    moments = rest[6:]
    opt = AdamState(
        mu=GaussianParams(*(t(a) for a in moments[:_NP])),
        nu=GaussianParams(*(t(a) for a in moments[_NP:2 * _NP])),
        step=GaussianParams(*(int(a) for a in moments[2 * _NP:3 * _NP])))
    key = np.asarray(moments[3 * _NP], np.uint64)
    gen = torch.Generator(device=dev).manual_seed(
        int(key[0]) << 32 | int(key[1]))
    return TrainState(pool, opt, gen), iteration, slr
