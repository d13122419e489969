"""What the ranks of tests/test_torch_sharded_surgery.py run (spawn_local).

Imports torch and the port only, never jax: the spawned children import
this module by name.  Every case runs one surgery event on this rank's
row shard (parallel/sharded.py:ShardRows) and the single-card event on
the same whole state with the same generator, and returns both whole
results (gather_state of the sharded one) as numpy arrays.
"""

import math
import sys

import numpy as np
import torch

from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models import gaussians as G
from reduced3dgs_torch.models.gaussians import GaussianParams, round_capacity
from reduced3dgs_torch.ops.sh_culling import (
    cull_sh_bands, render_transmittance,
)
from reduced3dgs_torch.parallel import sharded
from reduced3dgs_torch.parallel.sharded import (
    ShardedTrainer, ShardRows, all_gather_rows, gather_state, make_mesh,
    shard_state,
)
from reduced3dgs_torch.scene import Scene
from reduced3dgs_torch.train import adam
from reduced3dgs_torch.train import trainer as T
from reduced3dgs_torch.train.densify import MERCY_TYPES, WholeRows
from reduced3dgs_torch.train.trainer import TrainState

EXTENT = 3.0
SIZE = (48, 32)  # camera width, height
CULL = dict(threshold=0.04, std_threshold=0.04, budget=1 << 14,
            max_sh_degree=3, active_sh_degree=3)


def surgery_leaves(seed, cap, n_alive, lonely=False):
    """A whole pool's numpy leaves: n_alive alive rows scattered over the
    capacity (with `lonely`, none in the upper half of the slots), a
    knot of overlapping primitives for mercy, scales across the clone /
    split limit and the size prune, opacities across the opacity prune,
    densification statistics across the gradient threshold, SH degree 3;
    the Adam moments, step counts and pending gradients too."""
    rng = np.random.default_rng(seed)
    span = cap // 2 if lonely else cap
    rows = np.sort(rng.choice(span, n_alive, replace=False))
    alive = np.zeros(cap, bool)
    alive[rows] = True
    f32 = np.float32
    xyz = rng.uniform(-0.8, 0.8, (cap, 3)).astype(f32)
    xyz[rows[:n_alive // 4]] = rng.normal(0, 0.05, (n_alive // 4, 3))
    # rows whose SH bands above 0, 1 or 2 are zero, or none
    top = rng.integers(0, 4, cap)[:, None, None]
    band = np.repeat([1, 2, 3], [3, 5, 7])[None, :, None]
    scale = np.exp(rng.uniform(np.log(0.004), np.log(0.4), (cap, 1)))
    leaves = dict(
        xyz=xyz,
        features_dc=rng.normal(0, 0.5, (cap, 1, 3)).astype(f32),
        features_rest=np.where(band <= top, rng.normal(
            0, 0.3, (cap, 15, 3)), 0).astype(f32),
        scaling=np.log(scale * rng.uniform(0.6, 1, (cap, 3))).astype(f32),
        rotation=rng.normal(0, 1, (cap, 4)).astype(f32),
        opacity=rng.normal(0.5, 2.5, (cap, 1)).astype(f32),
        degrees=np.where(alive, 3, 0).astype(np.int32), alive=alive,
        max_radii2d=rng.uniform(0, 24, cap).astype(f32),
        xyz_grad_accum=rng.uniform(0, 4e-3, cap).astype(f32),
        denom=rng.integers(0, 12, cap).astype(f32),
        active_sh_degree=3)
    moments = {k: rng.normal(0, 1e-3, v.shape).astype(f32)
               for k, v in leaves.items() if k in GaussianParams._fields}
    grads = {k: rng.normal(0, 1e-2, v.shape).astype(f32)
             for k, v in moments.items()}
    return leaves, moments, grads


def whole_state(leaves, moments, device, seed=11):
    pool = G.pool_from_numpy(leaves, device)
    opt = adam.init(pool.params)

    def t(k):
        return torch.as_tensor(moments[k], device=device)

    opt = opt._replace(
        mu=GaussianParams(*(t(k) for k in GaussianParams._fields)),
        nu=GaussianParams(*(t(k).abs() for k in GaussianParams._fields)),
        step=GaussianParams(*([7] * 6)))
    return TrainState(pool, opt,
                      torch.Generator(device=device).manual_seed(seed))


def params_of(grads, device):
    return GaussianParams(*(torch.as_tensor(grads[k], device=device)
                            for k in GaussianParams._fields))


def cameras(n=3, size=SIZE):
    return [Camera.look_at(eye=(3 * math.cos(a), 0.5, 3 * math.sin(a)),
                           target=(0, 0, 0), width=size[0], height=size[1],
                           uid=i)
            for i, a in enumerate(np.linspace(0, 2 * np.pi, n,
                                              endpoint=False))]


class MiniScene:
    """The part of Scene the mercy pass reads: the training cameras."""

    def __init__(self, cams):
        self._cams = cams
        self.pool = None

    def get_train_cameras(self, scale=1.0):
        return self._cams

    calculate_redundancy_metric = Scene.calculate_redundancy_metric


def _np(t):
    return t.detach().cpu().numpy()


def state_arrays(state, pending=None):
    """Every carried leaf of a whole state (and pending gradients) as
    numpy arrays by name."""
    pool, opt, gen = state
    out = {f"param_{k}": _np(v) for k, v in zip(GaussianParams._fields,
                                                 pool.params)}
    out.update({f"mu_{k}": _np(v) for k, v in zip(GaussianParams._fields,
                                                   opt.mu)})
    out.update({f"nu_{k}": _np(v) for k, v in zip(GaussianParams._fields,
                                                   opt.nu)})
    out.update({k: _np(getattr(pool, k)) for k in (
        "degrees", "alive", "max_radii2d", "xyz_grad_accum", "denom")})
    out["next_draw"] = _np(torch.rand(4, generator=gen, device=pool.device))
    if pending is not None:
        out.update({f"grad_{k}": _np(v) for k, v in zip(
            GaussianParams._fields, pending)})
    return out


def _gathered(state, pending, mesh):
    whole = gather_state(state, mesh)
    if pending is not None:
        pending = GaussianParams(*(all_gather_rows(g, mesh.tile)
                                   for g in pending))
    return state_arrays(whole, pending)


def _stats(stats):
    return {k: float(v) for k, v in stats.items()}


def event_pairs(leaves, moments, grads, device, mesh, cams, log):
    """Each event on the shard and on the whole state, from the same
    state and generator: {event: (sharded, single, stats pair)}."""
    rows = ShardRows(mesh, log)
    whole_rows = WholeRows()
    cfg = OptimizationParams()
    scene = MiniScene(cams)
    out = {}

    def pair(name, fn):
        """fn(state, pending, rows) -> (state, pending, stats) on both
        layouts."""
        pend = params_of(grads, device)
        one = fn(whole_state(leaves, moments, device), pend, whole_rows)
        sh = fn(shard_state(whole_state(leaves, moments, device), mesh),
                GaussianParams(*(rows.mine(g) for g in pend)), rows)
        out[name] = (_gathered(sh[0], sh[1], mesh),
                     state_arrays(one[0], one[1]),
                     (_stats(sh[2]), _stats(one[2])))

    def densify(with_grads):
        def fn(st, pend, r):
            res = T.densify_step(st, EXTENT, pend if with_grads else None,
                                 opt_cfg=cfg, use_size_threshold=True,
                                 with_grads=with_grads, rows=r)
            return (res[0], res[2] if with_grads else None, res[1])
        return fn

    pair("densify_store_grads", densify(True))
    pair("densify", densify(False))

    def grow(st, pend, r):
        cap = r.capacity(st.pool)
        pool, opt, pend = r.grow(st.pool, st.opt, pend,
                                 round_capacity(2 * cap))
        return TrainState(pool, opt, st.generator), pend, {}

    pair("grow", grow)
    pair("opacity_reset",
         lambda st, pend, r: (T.opacity_reset_step(st), pend, {}))

    def prune_dead(st, pend, r):
        st, n = T.prune_dead_step(st, EXTENT, r)
        return st, pend, {"n": n}

    pair("prune_dead", prune_dead)
    for kind in MERCY_TYPES:
        def mercy(st, pend, r, kind=kind):
            red = T.mercy_counts(st, scene, pixel_scale=8.0, rows=r)
            st, stats = T.mercy_step(st, red, lambda_mercy=1.0,
                                     mercy_minimum=2, mercy_type=kind,
                                     rows=r)
            return st, pend, stats
        pair(f"mercy_{kind}", mercy)
    return out


def full_pool_pair(leaves, moments, grads, device, mesh):
    """Densify on a pool with fewer free slots than wanted rows."""
    rows = ShardRows(mesh)
    cfg = OptimizationParams()
    pend = params_of(grads, device)
    one = T.densify_step(whole_state(leaves, moments, device), EXTENT, pend,
                         opt_cfg=cfg, use_size_threshold=False,
                         with_grads=True)
    sh = T.densify_step(shard_state(whole_state(leaves, moments, device),
                                    mesh), EXTENT,
                        GaussianParams(*(rows.mine(g) for g in pend)),
                        opt_cfg=cfg, use_size_threshold=False,
                        with_grads=True, rows=rows)
    return (_gathered(sh[0], sh[2], mesh), state_arrays(one[0], one[2]),
            (_stats(sh[1]), _stats(one[1])))


def cull_pair(leaves, moments, device, mesh, cams, log):
    """cull_sh_bands on the shard (ShardRows.transmittance) and on the
    whole pool, and each camera's per-primitive transmittance both ways."""
    rows = ShardRows(mesh, log)
    st = whole_state(leaves, moments, device)
    pool = st.pool
    shard = shard_state(st, mesh).pool
    feats, shard_feats = pool.features(), shard.features()
    trans = []
    for cam in cams:
        cp = cam.params(device)
        one = render_transmittance(pool, feats, cp, budget=CULL["budget"],
                                   backend="tile")
        sh = rows.transmittance(shard, shard_feats, cp,
                                budget=CULL["budget"], backend="tile")
        trans.append(([_np(all_gather_rows(x, mesh.tile)) for x in sh],
                      [_np(x) for x in one]))
    kw = dict(CULL, backend="tile")
    one = cull_sh_bands(pool, cams, **kw)
    sh = cull_sh_bands(shard, cams, transmittance=rows.transmittance, **kw)
    got = gather_state(st._replace(pool=sh), mesh).pool
    fields = ("features_dc", "features_rest")
    return {"trans": trans,
            "sharded": {k: _np(getattr(got.params, k)) for k in fields}
            | {"degrees": _np(got.degrees)},
            "single": {k: _np(getattr(one.params, k)) for k in fields}
            | {"degrees": _np(one.degrees)}}


def events(rank, world, device, seed):
    """Mesh (1, world): every event on shards against the single card,
    on a pool with alive rows on every rank and on one whose last rank
    owns none; densify out of free slots; the cull; every collective's
    output bytes per global capacity row."""
    mesh = make_mesh(1, world)
    cams = cameras()
    log = []
    res = {"jax_imported": "jax" in sys.modules, "rank": rank}
    leaves, moments, grads = surgery_leaves(seed, 256, 96)
    res["events"] = event_pairs(leaves, moments, grads, device, mesh, cams,
                                log)
    lonely = surgery_leaves(seed + 1, 256, 120, lonely=True)
    res["lonely"] = event_pairs(*lonely, device, mesh, cams, None)
    full = surgery_leaves(seed + 2, 256, 250)
    res["full"] = full_pool_pair(*full, device, mesh)
    res["cull"] = cull_pair(leaves, moments, device, mesh, cams, log)
    res["log"] = log
    return res


def trainer_run(rank, world, device, shape, seed, cfg_kw, iters,
                n_alive=240):
    """ShardedTrainer (param_shard) on an (n_data, n_tile) mesh, or with
    shape None the single-card Trainer, for `iters` iterations from a
    256-slot pool with n_alive rows (more than 90 %: the first densify
    grows the pool), a cull at the last iteration; gather_state and
    sync_state raise during the sharded steps.  Returns the losses, the
    statistics and events, every surgery collective (ShardRows.log), the
    rows held here and the whole final state as this rank's tile group
    holds it."""
    cams = cameras(4, size=(32, 32))
    leaves, _, _ = surgery_leaves(seed, 256, n_alive)
    leaves["active_sh_degree"] = 0
    leaves["degrees"][:] = 0
    rng = np.random.default_rng(seed)
    for c in cams:
        c.image = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    kw = dict(spatial_lr_scale=EXTENT, background=np.zeros(3),
              backend="tile", seed=0, initial_budget=1 << 12,
              cull_sh_iterations=(iters,))
    pool, cfg = G.pool_from_numpy(leaves, device), OptimizationParams(**cfg_kw)
    if shape is None:
        t = T.Trainer(pool, cfg, cams, **kw)
    else:
        mesh = make_mesh(*shape)
        t = ShardedTrainer(pool, cfg, cams, mesh=mesh, param_shard=True,
                           **kw)
        t.rows.log = []
    t.extent = EXTENT

    def refuse(*a, **kw):
        raise AssertionError("a param_shard surgery gathered or synced "
                             "the whole state")

    saved = sharded.gather_state, sharded.sync_state
    sharded.gather_state = sharded.sync_state = refuse
    try:
        losses = [float(t.step(it)["loss"]) for it in range(1, iters + 1)]
    finally:
        sharded.gather_state, sharded.sync_state = saved
    st = t.state if shape is None else gather_state(t.state, mesh)
    return {"losses": losses, "stats": dict(t.stats),
            "events": dict(t.events), "log": t.rows.log,
            "rows_held": t.state.pool.capacity,
            "state": state_arrays(st),
            "jax_imported": "jax" in sys.modules}
