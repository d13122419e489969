"""Ragged variable-SH inference storage (PyTorch).

Counterpart of reduced3dgs_tpu/models/variable_sh.py.  After SH culling
the degrees are frozen, so the reference's ragged coefficient buffer
becomes static: the pool is reordered by degree once at load time and one
dense (N_d, (d+1)^2, 3) coefficient block is kept per band.  SH shading
is then four dense evaluations with no masking and no (P, 16, 3) buffer,
and everything downstream (preprocess, binning, compositing) takes the
per-primitive colours through ``color_precomp``.

Memory at inference: sum_d N_d (d+1)^2 3 floats for SH instead of P 48,
the PLY's on-disk layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reduced3dgs_torch.models.gaussians import GaussianParams, GaussianPool
from reduced3dgs_torch.ops import sh as sh_ops
from reduced3dgs_torch.ops import transforms as tf
from reduced3dgs_torch.utils import profiling


class RaggedSH(NamedTuple):
    """One packed block per band (may be empty)."""

    blocks: tuple  # per degree d: (N_d, (d+1)^2, 3) tensor
    sizes: tuple  # (N_0, N_1, N_2, N_3) Python ints


@profiling.spanned("r3dgs.load.build_ragged")
@torch.no_grad()
def build_ragged(pool: GaussianPool):
    """Reorder the pool's alive primitives by SH degree and pack the
    coefficients.  Returns (pool_sorted, ragged): pool_sorted has the
    alive rows first, grouped by degree (stable; dead rows last), and
    each block holds only its band's coefficient count.  Runs once per
    model load."""
    key = torch.where(pool.alive, pool.degrees, 99)
    order = torch.sort(key, stable=True).indices
    pool = pool.replace(
        params=GaussianParams(*(x[order] for x in pool.params)),
        degrees=pool.degrees[order], alive=pool.alive[order],
        max_radii2d=pool.max_radii2d[order],
        xyz_grad_accum=pool.xyz_grad_accum[order],
        denom=pool.denom[order])
    feats = pool.features()
    blocks, sizes = [], []
    start = 0
    for d in range(4):
        n = int(((pool.degrees == d) & pool.alive).sum())
        blocks.append(feats[start:start + n, :(d + 1) ** 2].contiguous())
        sizes.append(n)
        start += n
    return pool, RaggedSH(blocks=tuple(blocks), sizes=tuple(sizes))


def eval_colors(ragged: RaggedSH, xyz, campos):
    """Per-primitive clamped RGB for the first sum(sizes) (alive, degree-
    sorted) rows; rows past that get zeros.  Four dense batches."""
    p = xyz.shape[0]
    dirs_all = tf.normalize(xyz - campos[None, :], eps=1e-12)
    outs = []
    start = 0
    for d, (blk, n) in enumerate(zip(ragged.blocks, ragged.sizes)):
        if n == 0:
            continue
        deg = torch.full((n,), d, dtype=torch.int32, device=xyz.device)
        outs.append(sh_ops.eval_sh_color_clamped(
            blk, dirs_all[start:start + n], deg))
        start += n
    outs.append(torch.zeros((p - start, 3), dtype=torch.float32,
                            device=xyz.device))
    return torch.cat(outs, dim=0)
