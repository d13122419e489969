"""What the ranks of tests/test_torch_parallel.py run (spawn_local).

Imports torch and the port only, never jax: the spawned children import
this module by name.  Every case returns numpy arrays for the parent,
which holds them to the JAX package's sharded step.
"""

import sys

import numpy as np
import torch
from host_transfers import HostTransfers

from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models import gaussians as G
from reduced3dgs_torch.parallel import launch
from reduced3dgs_torch.parallel.sharded import (
    SHARDED_METRICS, Mesh, ShardedTrainer, all_gather_rows, gather_state,
    make_mesh, run_sharded_step_with_regrow, shard_state, sharded_fused_step,
    sharded_train_step, stack_camera_params,
)
from reduced3dgs_torch.train import adam
from reduced3dgs_torch.train.trainer import (
    StepLoop, Trainer, TrainState, _xyz_lr, adam_scalars, camera_vector,
    carried,
)

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
REG = dict(lambda_alpha_regul=0.001, lambda_sh_sparsity=0.1)
GROUP = 3  # iterations of a sharded step group
OVERFLOW_BUDGET = 64  # a budget every view overflows


def cameras(scene):
    """Port cameras (with images) from the parent's scene description."""
    cams = []
    for uid, (eye, img) in enumerate(zip(scene["eyes"], scene["images"])):
        c = Camera.look_at(eye=eye, target=(0, 0, 0), width=scene["w"],
                           height=scene["h"], uid=uid)
        c.image = img
        cams.append(c)
    return cams


def state_from(leaves, device):
    pool = G.pool_from_numpy(leaves, device)
    return TrainState(pool, adam.init(pool.params),
                      torch.Generator(device=device).manual_seed(0))


def _np(t):
    return t.detach().cpu().numpy()


def _step_out(state, metrics, mesh, param_shard):
    st = gather_state(state, mesh, param_shard)
    pool = st.pool
    out = {k: float(v) for k, v in metrics.items()}
    out.update({f"param_{k}": _np(v) for k, v in zip(LEAVES, pool.params)})
    out.update({k: _np(getattr(pool, k))
                for k in ("xyz_grad_accum", "denom", "max_radii2d")})
    out["mu_xyz"] = _np(st.opt.mu.xyz)
    return out


def step_kw(scene, budget, cfg, **kw):
    return dict(width=scene["w"], height=scene["h"], budget=budget,
                opt_cfg=cfg, spatial_lr_scale=3.0, **kw)


def sharded_trainer(scene, leaves, device, mesh, param_shard,
                    budget=None, **cfg_kw):
    """ShardedTrainer from the parent's scene and pool leaves (seed 0)."""
    t = ShardedTrainer(G.pool_from_numpy(leaves, device),
                       OptimizationParams(**cfg_kw), cameras(scene),
                       mesh=mesh, param_shard=param_shard,
                       spatial_lr_scale=3.0, background=np.zeros(3),
                       backend="tile", seed=0,
                       initial_budget=budget or scene["budget"])
    t.extent = 3.0
    return t


def _run_out(t, ms, mesh):
    """A trainer run for the parent: its metrics, every carried leaf of
    the whole state, degrees, alive, step counts, budgets and the next
    draw of its random stream."""
    st = gather_state(t.state, mesh, t.param_shard)
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in ms],
            "leaves": [_np(x) for x in carried(st)
                       + (st.pool.degrees, st.pool.alive)],
            "params": {k: _np(v) for k, v in zip(LEAVES, st.pool.params)},
            "steps": list(t.state.opt.step), "budgets": dict(t.budgets),
            "next_draw": float(t.rng.uniform())}


def group_cases(scene, leaves, device, mesh, layouts, sequential=True,
                **cfg_kw):
    """Per layout, a step_group of GROUP iterations and (sequential) as
    many ShardedTrainer.step calls from the same trainer state."""
    out = {}
    for shard in layouts:
        runs = []
        for grouped in ((False, True) if sequential else (True,)):
            t = sharded_trainer(scene, leaves, device, mesh, shard,
                                **cfg_kw)
            its = range(1, GROUP + 1)
            ms = t.step_group(its) if grouped else [t.step(i) for i in its]
            runs.append(_run_out(t, ms, mesh))
        out[shard] = runs
    return out


def host_transfer_check(scene, leaves, device, mesh):
    """One sharded_fused_step per layout (replicated f32, param_shard
    bf16x2) under HostTransfers: what the captured step would hold."""
    cams = cameras(scene)
    cfg = OptimizationParams(**REG)
    vec = torch.as_tensor(np.concatenate([
        camera_vector(cams[0]), np.zeros(3),
        [0.1 ** i for i in range(1, 14)]]).astype(np.float32))
    out = []
    for shard, mode in ((False, "f32"), (True, "bf16x2")):
        st = shard_state(state_from(leaves, device), mesh, shard)
        loop = StepLoop(st, dict(mesh=mesh, param_shard=shard,
                                 width=scene["w"], height=scene["h"],
                                 budget=4096, opt_cfg=cfg, grad_reduce=mode,
                                 active_sh_degree=0),
                        sharded_fused_step, SHARDED_METRICS)
        loop.buf.load(st)
        loop.buf.vec.copy_(vec)
        loop.buf.gt.copy_(torch.as_tensor(cams[0].image))
        watch = HostTransfers()
        with watch:
            loop.replay()
        out.append({"bad": watch.bad, "ops": len(watch.seen),
                    "nr": int(loop.buf.out_i[0])})
    return out


def one_by_four(rank, world, device, scene, leaves):
    """Mesh (1, 4): the full step in both layouts, the raw gradients of
    both layouts, and what each rank holds under param_shard."""
    mesh = make_mesh(1, 4)
    cams = cameras(scene)
    cp = stack_camera_params(cams[:1], device)
    gts = [torch.as_tensor(cams[0].image, device=device)]
    bg = torch.zeros(3, device=device)
    res = {"jax_imported": "jax" in sys.modules}
    state = state_from(leaves, device)
    st, m = sharded_train_step(state, cp, gts, bg, 1, mesh=mesh,
                               **step_kw(scene, 4096, OptimizationParams()))
    res["replicated"] = _step_out(st, m, mesh, False)
    cfg = OptimizationParams(**REG)
    for param_shard in (False, True):
        st_in = shard_state(state, mesh, param_shard)
        _, _, g = sharded_train_step(
            st_in, cp, gts, bg, 1, mesh=mesh, param_shard=param_shard,
            skip_update=True, **step_kw(scene, 4096, cfg))
        if param_shard:
            g = [all_gather_rows(x, mesh.tile) for x in g]
        res[f"grads_{param_shard}"] = {k: _np(v) for k, v in zip(LEAVES, g)}
    st_in = shard_state(state, mesh, True)
    st, m = sharded_train_step(st_in, cp, gts, bg, 1, mesh=mesh,
                               param_shard=True, **step_kw(scene, 4096, cfg))
    res["sharded"] = _step_out(st, m, mesh, True)
    res["rows_held"] = {
        "param": st.pool.params.xyz.shape[0], "mu": st.opt.mu.xyz.shape[0],
        "nu": st.opt.nu.opacity.shape[0], "alive": st.pool.alive.shape[0],
        "denom": st.pool.denom.shape[0],
        "rows": _np(st.pool.params.xyz)}
    res["groups"] = group_cases(scene, leaves, device, mesh, (False, True))
    res["overflow"] = group_cases(scene, leaves, device, mesh, (True,),
                                  budget=OVERFLOW_BUDGET,
                                  random_background=True)[True]
    res["host_transfers"] = host_transfer_check(scene, leaves, device, mesh)
    return res


def trainer_run(rank, world, device, scene, leaves, cfg_kw, iters,
                sharded=True):
    """ShardedTrainer (param_shard, mesh (1, world)) or, with sharded
    False, the single-card Trainer for `iters` iterations; the losses, the
    events' statistics, the budgets and the whole final pool."""
    from reduced3dgs_torch.scene import Scene

    class MiniScene:
        def __init__(self, cams_):
            self._cams = cams_
            self.pool = None

        def get_train_cameras(self, scale=1.0):
            return self._cams

        calculate_redundancy_metric = Scene.calculate_redundancy_metric

    cams = cameras(scene)
    cfg = OptimizationParams(**cfg_kw)
    pool = G.pool_from_numpy(leaves, device)
    kw = dict(spatial_lr_scale=3.0, background=np.zeros(3), backend="tile",
              seed=0, initial_budget=scene["budget"], scene=MiniScene(cams))
    if sharded:
        mesh = make_mesh(1, world)
        t = ShardedTrainer(pool, cfg, cams, mesh=mesh, param_shard=True,
                           **kw)
    else:
        t = Trainer(pool, cfg, cams, **kw)
    t.extent = 3.0
    losses = [float(t.step(it)["loss"]) for it in range(1, iters + 1)]
    st = gather_state(t.state, mesh, True) if sharded else t.state
    return {"losses": losses, "alive": _np(st.pool.alive),
            "stats": dict(t.stats), "budgets": dict(t.budgets),
            "params": {k: _np(v) for k, v in zip(LEAVES, st.pool.params)},
            "rows_held": t.state.pool.capacity}


def two_by_two(rank, world, device, scene, leaves):
    """Mesh (2, 2): a data-parallel batch of two cameras, and the scaling
    harness on (1, 1) and (2, 2)."""
    mesh = make_mesh(2, 2)
    cams = cameras(scene)
    cp = stack_camera_params(cams[:2], device)
    gts = [torch.as_tensor(c.image, device=device) for c in cams[:2]]
    state = state_from(leaves, device)
    st, m = sharded_train_step(state, cp, gts, torch.zeros(3, device=device),
                               1, mesh=mesh,
                               **step_kw(scene, 4096, OptimizationParams()))
    res = {"batch": _step_out(st, m, mesh, False),
           "jax_imported": "jax" in sys.modules}
    lines = []
    res["scaling"] = launch.scaling_bench(
        widths=(64,), n_prims=256, budget=4096, iters=2,
        mesh_shapes=[(1, 1), (2, 2)], device=device, printer=lines.append)
    res["scaling_lines"] = lines
    res["groups"] = group_cases(scene, leaves, device, mesh, (True,),
                                sequential=False)[True]
    return res


def one_by_two(rank, world, device, scene, leaves):
    """Mesh (1, 2): the overflow contract."""
    mesh = make_mesh(1, 2)
    cams = cameras(scene)
    cp = stack_camera_params(cams[:1], device)
    gts = [torch.as_tensor(cams[0].image, device=device)]
    bg = torch.zeros(3, device=device)
    cfg = OptimizationParams()
    state = state_from(leaves, device)
    _, m_small = sharded_train_step(state, cp, gts, bg, 1, mesh=mesh,
                                    **step_kw(scene, 128, cfg))
    st_g, m_g, budget = run_sharded_step_with_regrow(
        state, cp, gts, bg, 1, mesh=mesh, **step_kw(scene, 128, cfg))
    st_b, m_b = sharded_train_step(state, cp, gts, bg, 1, mesh=mesh,
                                   **step_kw(scene, budget, cfg))
    lines = []
    launch.scaling_bench(widths=(64,), n_prims=256, budget=4096, iters=1,
                         mesh_shapes=[(1, 1), (1, 2)], device=device,
                         printer=lines.append)
    return {"needed": int(m_small["num_rendered_max"]),
            "small_loss": float(m_small["loss"]), "budget": budget,
            "grown": _step_out(st_g, m_g, mesh, False),
            "big": _step_out(st_b, m_b, mesh, False),
            "scaling_lines": lines,
            "scaling_eager": [scaling_reference(device, s, steps=2)
                              for s in ((1, 1), (1, 2))],
            "jax_imported": "jax" in sys.modules}


def scaling_reference(device, shape, width=64, n_prims=256, budget=4096,
                      steps=2):
    """The loss of scaling_bench's last step computed apart: its scene,
    this rank's camera and Adam's scalars of iteration 1, `steps` eager
    sharded_train_step calls (its warm-up and its timed steps)."""
    nd, nt = shape
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.0, 1.0, (n_prims, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n_prims, 3)).astype(np.float32)
    pool = G.create_from_pcd(pts, cols, capacity=n_prims, device=device)
    state = TrainState(pool, adam.init(pool.params),
                       torch.Generator(device=device).manual_seed(0))
    mesh = Mesh(nd, nt, alone=shape == (1, 1))
    d = mesh.data_idx
    cam = Camera.look_at(eye=(np.cos(d), 0.2, -3 + 0.1 * d),
                         target=(0, 0, 0), width=width, height=width, uid=d)
    cfg = OptimizationParams()
    c1, c2 = adam.corrections(1)
    scalars = adam_scalars(torch.as_tensor(np.float32(
        [_xyz_lr(1, cfg, 1.0)] + [c1] * 6 + [c2] * 6), device=device))
    gts = [torch.zeros((width, width, 3), device=device)] * nd
    for _ in range(steps):
        state, m = sharded_train_step(
            state, [cam.params(device)] * nd, gts,
            torch.zeros(3, device=device), 1, mesh=mesh, width=width,
            height=width, budget=budget, opt_cfg=cfg, spatial_lr_scale=1.0,
            adam_scalars=scalars)
    return float(m["loss"])
