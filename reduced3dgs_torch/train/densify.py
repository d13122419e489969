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
"""

from __future__ import annotations

import torch

from reduced3dgs_torch.models.gaussians import GaussianPool
from reduced3dgs_torch.ops.transforms import quat_to_rotmat
from reduced3dgs_torch.train.adam import AdamState


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


def _scatter_rows(leaves, dst, ok, src_leaves):
    """leaves[dst[i]] = src_leaves[i] where ok[i]."""
    d = dst[ok]
    out = []
    for x, v in zip(leaves, src_leaves):
        x = x.clone()
        x[d] = v[ok]
        out.append(x)
    return type(leaves)(*out)


def _zero_rows(leaves, dst, ok):
    d = dst[ok]
    out = []
    for x in leaves:
        x = x.clone()
        x[d] = 0
        out.append(x)
    return type(leaves)(*out)


def _insert(pool: GaussianPool, opt: AdamState, want, src_params,
            src_degrees, grads_tree=None):
    """Insert rows built from per-source arrays into free slots: new rows
    get zero Adam moments and (store_grads) zero pending gradients."""
    dst, ok, dropped = _allocate(pool.alive, want)
    params = _scatter_rows(pool.params, dst, ok, src_params)
    d = dst[ok]
    degrees = pool.degrees.clone()
    degrees[d] = src_degrees[ok]
    alive = pool.alive.clone()
    alive[d] = True
    opt = opt._replace(mu=_zero_rows(opt.mu, dst, ok),
                       nu=_zero_rows(opt.nu, dst, ok))
    if grads_tree is not None:
        grads_tree = _zero_rows(grads_tree, dst, ok)
    pool = pool.replace(params=params, degrees=degrees, alive=alive)
    return pool, opt, grads_tree, ok.sum(), dropped


def prune_points(pool: GaussianPool, opt: AdamState, mask):
    """Drop the masked primitives: clear their alive bits (their Adam rows
    are zeroed when the slot is reused)."""
    return pool.replace(alive=pool.alive & ~mask), opt, mask.sum()


def densify_and_clone(pool, opt, grads_avg, grad_threshold, percent_dense,
                      extent, grads_tree=None):
    max_scale = pool.get_scaling().amax(dim=1)
    sel = (pool.alive & (grads_avg >= grad_threshold)
           & (max_scale <= percent_dense * extent))
    return _insert(pool, opt, sel, pool.params, pool.degrees, grads_tree)


def densify_and_split(pool, opt, grads_avg, grad_threshold, percent_dense,
                      extent, n_split=2, grads_tree=None, normals=None,
                      generator=None):
    """Split big high-gradient primitives into n_split children sampled
    from the primitive's own Gaussian, scales / (0.8 n_split).  Child 1
    overwrites the source slot; the others go to free slots.

    normals: optional (n_split, C, 3) standard normal samples (the tests
    pass the JAX package's jax.random.normal draws); by default they are
    drawn on the pool's device from `generator`.
    """
    scales = pool.get_scaling()
    max_scale = scales.amax(dim=1)
    sel = (pool.alive & (grads_avg >= grad_threshold)
           & (max_scale > percent_dense * extent))
    c = pool.capacity
    if normals is None:
        normals = torch.randn((n_split, c, 3), generator=generator,
                              device=pool.device)
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
    idx = torch.arange(c, device=pool.device)
    opt = opt._replace(mu=_zero_rows(opt.mu, idx, sel),
                       nu=_zero_rows(opt.nu, idx, sel))
    if grads_tree is not None:
        grads_tree = _zero_rows(grads_tree, idx, sel)
    dropped_total = torch.zeros((), dtype=torch.int64, device=pool.device)
    for i in range(1, n_split):
        pool, opt, grads_tree, _, dropped = _insert(
            pool, opt, sel, child_params(i), pool.degrees, grads_tree)
        dropped_total = dropped_total + dropped
    return pool, opt, grads_tree, sel.sum(), dropped_total


def prune(pool, opt, min_opacity, extent, max_screen_size):
    """Opacity / size pruning; max_screen_size=0 disables the size
    tests."""
    mask = pool.alive & (pool.get_opacity()[:, 0] < min_opacity)
    if max_screen_size:
        big_vs = pool.max_radii2d > max_screen_size
        big_ws = pool.get_scaling().amax(dim=1) > 0.1 * extent
        mask = mask | (pool.alive & (big_vs | big_ws))
    return prune_points(pool, opt, mask)


def densify_and_prune(pool, opt, max_grad, min_opacity, extent,
                      max_screen_size, percent_dense, grads_tree=None,
                      normals=None, generator=None):
    """Full densify step: clone, split, prune, and reset the statistics.
    Returns (pool, opt, grads_tree, stats dict of 0-dim tensors)."""
    grads_avg = pool.xyz_grad_accum / torch.clamp(pool.denom, min=1e-20)
    grads_avg = torch.where(torch.isnan(grads_avg) | (pool.denom == 0),
                            0.0, grads_avg)
    pool, opt, grads_tree, n_cloned, d1 = densify_and_clone(
        pool, opt, grads_avg, max_grad, percent_dense, extent, grads_tree)
    pool, opt, grads_tree, n_split, d2 = densify_and_split(
        pool, opt, grads_avg, max_grad, percent_dense, extent,
        grads_tree=grads_tree, normals=normals, generator=generator)
    pool, opt, n_pruned = prune(pool, opt, min_opacity, extent,
                                max_screen_size)
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
                 uniform=None):
    """Prune over-represented primitives by redundancy score.

    splat_counts: (C,) the per-primitive minimum redundancy value from
    ops/redundancy.py.  redundancy_random keeps a coin flip per
    primitive: `uniform` (C,) in [0, 1) if given (the tests pass the JAX
    package's draws), else drawn from `generator` on the pool's device.
    Returns (pool, opt, stats dict of 0-dim tensors)."""
    if mercy_type not in MERCY_TYPES:
        raise ValueError(f"unknown mercy_type {mercy_type!r}")
    alive = pool.alive
    counts = splat_counts.to(torch.float32)
    n = alive.sum().to(torch.float32)
    mean = torch.where(alive, counts, 0.0).sum() / torch.clamp(n, min=1.0)
    var = torch.where(alive, (counts - mean) ** 2, 0.0).sum() \
        / torch.clamp(n - 1.0, min=1.0)
    redundancy_threshold = mean + lambda_mercy * torch.sqrt(var)
    threshold = torch.clamp(redundancy_threshold, min=float(mercy_minimum))
    mask = alive & (counts > threshold)
    opacity = pool.get_opacity()[:, 0]
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

    pool, opt, n_mercied = prune_points(pool, opt, mask)
    return pool, opt, {"n_points_mercied": n_mercied,
                       "redundancy_threshold": redundancy_threshold,
                       "opacity_threshold": opacity_threshold}
