"""What the ranks of tests/test_torch_parallel.py run (spawn_local).

Imports torch and the port only, never jax: the spawned children import
this module by name.  Every case returns numpy arrays for the parent,
which holds them to the JAX package's sharded step.
"""

import sys

import numpy as np
import torch

from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models import gaussians as G
from reduced3dgs_torch.parallel import launch
from reduced3dgs_torch.parallel.sharded import (
    ShardedTrainer, all_gather_rows, gather_state, make_mesh,
    run_sharded_step_with_regrow, shard_state, sharded_train_step,
    stack_camera_params,
)
from reduced3dgs_torch.train import adam
from reduced3dgs_torch.train.trainer import Trainer, TrainState

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
REG = dict(lambda_alpha_regul=0.001, lambda_sh_sparsity=0.1)


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
    return {"needed": int(m_small["num_rendered_max"]),
            "small_loss": float(m_small["loss"]), "budget": budget,
            "grown": _step_out(st_g, m_g, mesh, False),
            "big": _step_out(st_b, m_b, mesh, False),
            "jax_imported": "jax" in sys.modules}
