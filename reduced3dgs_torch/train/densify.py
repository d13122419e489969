"""Densification / pruning on the fixed-capacity pool (PyTorch).

Counterpart of reduced3dgs_tpu/train/densify.py: cloning and splitting
write into free slots, pruning clears alive bits, and the Adam "surgery"
zeroes (mu, nu) rows at the touched slots — the reference's cat/slice of
exp_avg tensors on a pool of fixed shape.  Every function returns new
tensors and keeps the slot layout of the JAX package, so both packages
hold the same primitives in the same slots.

Slot exhaustion drops the last allocations in slot order and reports the
count, so the host can grow the pool.  Mercy culling (``mercy_points``)
prunes by the redundancy metric of ops/redundancy.py.

Every event is a decision and its application.  The decision reads whole
columns (free slots and the rows that want one, the opacity and
redundancy thresholds); the application is a masked write of each row.
The functions take the pool's row layout as ``rows``: ``WholeRows`` (the
default) holds every row on this device, and
parallel/sharded.py:ShardRows holds a tile member's contiguous shard,
gathers the single columns a decision reads, so that every member
computes the decision of the whole pool, and moves the rows a decision
sends to another member.
"""

from __future__ import annotations

import torch

from reduced3dgs_torch.models.gaussians import GaussianPool, grow
from reduced3dgs_torch.ops.sh_culling import render_transmittance
from reduced3dgs_torch.ops.transforms import quat_to_rotmat
from reduced3dgs_torch.train.adam import AdamState


def grow_leaf(x, old_cap, new_cap):
    """Pad a per-slot tensor with zero rows (other values pass)."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == old_cap:
        return torch.cat([x, x.new_zeros((new_cap - old_cap,)
                                         + x.shape[1:])])
    return x


def _grow_params(leaves, old_cap, new_cap):
    return type(leaves)(*(grow_leaf(x, old_cap, new_cap) for x in leaves))


class WholeRows:
    """Every row of the pool on this device: the row layout of the
    single-card surgery.  parallel/sharded.py:ShardRows has the same
    methods for a tile member's row shard; global row numbers are pool
    slots."""

    log = None  # collectives run: none here

    def capacity(self, pool):
        """The pool's global capacity."""
        return pool.capacity

    def column(self, x):
        """The whole column of a per-row tensor."""
        return x

    def mine(self, x, dim=0):
        """This device's rows (along `dim`) of a whole column."""
        return x

    def total(self, mask):
        """The count of a per-row mask over every row."""
        return mask.sum()

    def put(self, leaves, src_leaves, src, dst):
        """leaves[dst[k]] = src_leaves[src[k]] for every k (global rows,
        src increasing, dst distinct), as new tensors.  Returns (the new
        leaves, the local positions of the dst rows held here)."""
        out = []
        for x, v in zip(leaves, src_leaves):
            x = x.clone()
            x[dst] = v[src]
            out.append(x)
        return out, dst

    def grow(self, pool, opt, pending, new_cap):
        """The pool, Adam moments and pending gradients padded with dead
        rows up to the global capacity new_cap (models/gaussians.grow)."""
        cap = pool.capacity
        opt = opt._replace(mu=_grow_params(opt.mu, cap, new_cap),
                           nu=_grow_params(opt.nu, cap, new_cap))
        if pending is not None:
            pending = _grow_params(pending, cap, new_cap)
        return grow(pool, new_cap), opt, pending

    # (radii, trans_sum, touched) of this device's rows in one view
    transmittance = staticmethod(render_transmittance)


WHOLE = WholeRows()


def _allocate(alive, want):
    """One distinct free slot per wanted source row: (dst (C,), ok (C,),
    n_dropped); ok marks the sources that got a slot."""
    c = alive.shape[0]
    free_first = torch.argsort(alive.to(torch.int8), stable=True)
    n_free = c - alive.sum()
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (rank < n_free)
    dst = free_first[torch.clamp(rank, 0, c - 1)]
    return dst, ok, want.sum() - ok.sum()


def _zero_rows(leaves, idx):
    out = []
    for x in leaves:
        x = x.clone()
        x[idx] = 0
        out.append(x)
    return type(leaves)(*out)


def _insert(pool: GaussianPool, opt: AdamState, want, src_params,
            src_degrees, grads_tree=None, rows=WHOLE):
    """Insert rows built from per-source arrays into free slots: new rows
    get zero Adam moments and (store_grads) zero pending gradients.  The
    slots are decided on the whole alive and want columns."""
    dst, ok, dropped = _allocate(rows.column(pool.alive), rows.column(want))
    src = torch.nonzero(ok)[:, 0]
    d = dst[ok]
    moved, here = rows.put(tuple(pool.params) + (pool.degrees,),
                           tuple(src_params) + (src_degrees,), src, d)
    alive = pool.alive.clone()
    alive[here] = True
    opt = opt._replace(mu=_zero_rows(opt.mu, here),
                       nu=_zero_rows(opt.nu, here))
    if grads_tree is not None:
        grads_tree = _zero_rows(grads_tree, here)
    pool = pool.replace(params=type(pool.params)(*moved[:-1]),
                        degrees=moved[-1], alive=alive)
    return pool, opt, grads_tree, ok.sum(), dropped


def prune_points(pool: GaussianPool, opt: AdamState, mask, rows=WHOLE):
    """Drop the masked primitives: clear their alive bits (their Adam rows
    are zeroed when the slot is reused)."""
    return pool.replace(alive=pool.alive & ~mask), opt, rows.total(mask)


def densify_and_clone(pool, opt, grads_avg, grad_threshold, percent_dense,
                      extent, grads_tree=None, rows=WHOLE):
    max_scale = pool.get_scaling().amax(dim=1)
    sel = (pool.alive & (grads_avg >= grad_threshold)
           & (max_scale <= percent_dense * extent))
    return _insert(pool, opt, sel, pool.params, pool.degrees, grads_tree,
                   rows)


def densify_and_split(pool, opt, grads_avg, grad_threshold, percent_dense,
                      extent, n_split=2, grads_tree=None, normals=None,
                      generator=None, rows=WHOLE):
    """Split big high-gradient primitives into n_split children sampled
    from the primitive's own Gaussian, scales / (0.8 n_split).  Child 1
    overwrites the source slot; the others go to free slots.

    normals: optional (n_split, C, 3) standard normal samples over the
    whole capacity C (the tests pass the JAX package's jax.random.normal
    draws); by default they are drawn on the pool's device from
    `generator`, the whole shape on every tile member, so that the
    generator advances alike everywhere.
    """
    scales = pool.get_scaling()
    max_scale = scales.amax(dim=1)
    sel = (pool.alive & (grads_avg >= grad_threshold)
           & (max_scale > percent_dense * extent))
    c = pool.capacity
    if normals is None:
        normals = torch.randn((n_split, rows.capacity(pool), 3),
                              generator=generator, device=pool.device)
    normals = rows.mine(normals, dim=1)
    rot = quat_to_rotmat(pool.get_rotation())  # (C, 3, 3)
    noise = normals * scales[None]
    child_xyz = torch.einsum("cij,ncj->nci", rot, noise) \
        + pool.params.xyz[None]
    child_scaling = torch.log(scales / (0.8 * n_split))

    def child_params(i):
        return pool.params._replace(xyz=child_xyz[i], scaling=child_scaling)

    def overwrite(x, v):
        m = sel.reshape((c,) + (1,) * (x.ndim - 1))
        return torch.where(m, v, x)

    params = type(pool.params)(*(overwrite(x, v) for x, v in
                                 zip(pool.params, child_params(0))))
    pool = pool.replace(params=params)
    opt = opt._replace(mu=_zero_rows(opt.mu, sel),
                       nu=_zero_rows(opt.nu, sel))
    if grads_tree is not None:
        grads_tree = _zero_rows(grads_tree, sel)
    dropped_total = torch.zeros((), dtype=torch.int64, device=pool.device)
    for i in range(1, n_split):
        pool, opt, grads_tree, _, dropped = _insert(
            pool, opt, sel, child_params(i), pool.degrees, grads_tree, rows)
        dropped_total = dropped_total + dropped
    return pool, opt, grads_tree, rows.total(sel), dropped_total


def prune(pool, opt, min_opacity, extent, max_screen_size, rows=WHOLE):
    """Opacity / size pruning; max_screen_size=0 disables the size
    tests.  Every test is of the row itself."""
    mask = pool.alive & (pool.get_opacity()[:, 0] < min_opacity)
    if max_screen_size:
        big_vs = pool.max_radii2d > max_screen_size
        big_ws = pool.get_scaling().amax(dim=1) > 0.1 * extent
        mask = mask | (pool.alive & (big_vs | big_ws))
    return prune_points(pool, opt, mask, rows)


def densify_and_prune(pool, opt, max_grad, min_opacity, extent,
                      max_screen_size, percent_dense, grads_tree=None,
                      normals=None, generator=None, rows=WHOLE):
    """Full densify step: clone, split, prune, and reset the statistics.
    Returns (pool, opt, grads_tree, stats dict of 0-dim tensors, counts
    over the whole pool)."""
    grads_avg = pool.xyz_grad_accum / torch.clamp(pool.denom, min=1e-20)
    grads_avg = torch.where(torch.isnan(grads_avg) | (pool.denom == 0),
                            0.0, grads_avg)
    pool, opt, grads_tree, n_cloned, d1 = densify_and_clone(
        pool, opt, grads_avg, max_grad, percent_dense, extent, grads_tree,
        rows)
    pool, opt, grads_tree, n_split, d2 = densify_and_split(
        pool, opt, grads_avg, max_grad, percent_dense, extent,
        grads_tree=grads_tree, normals=normals, generator=generator,
        rows=rows)
    pool, opt, n_pruned = prune(pool, opt, min_opacity, extent,
                                max_screen_size, rows)
    zeros = torch.zeros_like(pool.denom)
    pool = pool.replace(xyz_grad_accum=zeros, denom=zeros.clone(),
                        max_radii2d=zeros.clone())
    stats = {"n_points_cloned": n_cloned, "n_points_split": n_split,
             "n_points_pruned": n_pruned, "n_dropped_capacity": d1 + d2}
    return pool, opt, grads_tree, stats


# ---------------------------------------------------------------------------
# masked statistics (torch.quantile / torch.median over the masked subset)
# ---------------------------------------------------------------------------

def masked_quantile(values, mask, q):
    """torch.quantile (linear interpolation) over the masked subset, with
    static shapes as the JAX package computes it."""
    s = torch.sort(torch.where(mask, values, torch.inf)).values
    n = mask.sum()
    last = values.shape[0] - 1
    pos = q * (n.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = pos - lo.to(torch.float32)
    upper = torch.where(hi < n, s[hi], s[torch.clamp(n - 1, min=0)])
    return s[lo] * (1.0 - frac) + upper * frac


def masked_median(values, mask):
    """torch.median over the masked subset: the lower of the two middle
    elements."""
    s = torch.sort(torch.where(mask, values, torch.inf)).values
    n = mask.sum()
    return s[torch.clamp((n - 1) // 2, min=0)]


# ---------------------------------------------------------------------------
# mercy culling
# ---------------------------------------------------------------------------

MERCY_TYPES = ("redundancy_opacity", "redundancy_random", "opacity",
               "redundancy_opacity_opacity")


def mercy_points(pool, opt, splat_counts, lambda_mercy=2.0, mercy_minimum=2,
                 mercy_type="redundancy_opacity", generator=None,
                 uniform=None, rows=WHOLE):
    """Prune over-represented primitives by redundancy score.

    splat_counts: (C,) the per-primitive minimum redundancy value from
    ops/redundancy.py, over the whole capacity C.  redundancy_random keeps
    a coin flip per primitive: `uniform` (C,) in [0, 1) if given (the
    tests pass the JAX package's draws), else drawn from `generator` on
    the pool's device.  The mask is decided on the whole alive and
    opacity columns (the same bits on every tile member) and applied to
    this device's rows.  Returns (pool, opt, stats dict of 0-dim
    tensors)."""
    if mercy_type not in MERCY_TYPES:
        raise ValueError(f"unknown mercy_type {mercy_type!r}")
    alive = rows.column(pool.alive)
    counts = splat_counts.to(torch.float32)
    n = alive.sum().to(torch.float32)
    mean = torch.where(alive, counts, 0.0).sum() / torch.clamp(n, min=1.0)
    var = torch.where(alive, (counts - mean) ** 2, 0.0).sum() \
        / torch.clamp(n - 1.0, min=1.0)
    redundancy_threshold = mean + lambda_mercy * torch.sqrt(var)
    threshold = torch.clamp(redundancy_threshold, min=float(mercy_minimum))
    mask = alive & (counts > threshold)
    opacity = rows.column(pool.get_opacity()[:, 0])
    # the reference reports 0 for the redundancy-only types
    opacity_threshold = torch.zeros((), dtype=torch.float32,
                                    device=pool.device)

    if mercy_type == "redundancy_opacity":
        mask = mask & (opacity < masked_median(opacity, mask))
    elif mercy_type == "redundancy_random":
        if uniform is None:
            uniform = torch.rand(mask.shape, generator=generator,
                                 device=pool.device)
        mask = mask & (uniform < 0.5)
    elif mercy_type == "opacity":
        opacity_threshold = masked_quantile(opacity, alive, 0.045)
        mask = alive & (opacity < opacity_threshold)
    else:  # redundancy_opacity_opacity
        mask = mask & (opacity < masked_median(opacity, mask))
        opacity_threshold = torch.clamp(
            masked_quantile(opacity, alive, 0.03), max=0.05)
        mask = mask | (alive & (opacity < opacity_threshold))

    pool = pool.replace(alive=pool.alive & ~rows.mine(mask))
    return pool, opt, {"n_points_mercied": mask.sum(),
                       "redundancy_threshold": redundancy_threshold,
                       "opacity_threshold": opacity_threshold}
