"""The port's whole Trainer.step loop against the JAX package's over one
schedule with every event, on the CPU.

Both trainers start from one 120-point pool in 128 slots at SH degree 2
(its degree-1 and degree-2 coefficients drawn at random),
on tests/test_training.py's scene (four 48x48 views of 24 Gaussians), the
"xla" oracle in the JAX package and "ref" in the port, f32, at an
initial budget of 1024 instances, and step through iterations 991-1006
of a 5,000-iteration schedule with the paper's regularizers (SH
sparsity, alpha) and culling thresholds:

* densify with store_grads at 992 and 996, the first one growing the pool
  to 1024 slots (more than 90 % of the slots alive);
* an opacity reset at 994 (interval 497) and mercy of the
  "redundancy_random" type at 992 (after that densify) and 1000
  (interval 2 x 4);
* the SH-degree step at 1000 (the JAX package's hard-coded
  ``iteration % 1000``), dead-point pruning at 1000 and 1004 (after
  densify_until_iter), and the SH cull at 1002.

The port receives the JAX key's draws: the test splits the JAX trainer's
key as reduced3dgs_tpu/train/trainer.py does (densify_step :225,
mercy_step :241) and passes the split normals and the mercy coin flips to
the port's densify_step / mercy_step (``normals=``, ``uniform=``).
Every loss within 1e-4 relative, num_rendered within 2, the alive masks,
degrees, capacities and every event's statistics equal after every
iteration, the key chain the JAX trainer's, and every parameter within
atol 1e-3 at the end.  The mercy threshold (the alive rows' mean
redundancy count plus lambda standard deviations) is held within 2e-3
relative: a box at a pixel boundary may flip one count by one under the
two packages' rounding, which moves the threshold by ~4e-4 and, unless
it crosses the threshold, no mask.

A second, shorter leg runs the training default on both: the port's
"tile" backend (the kernels' plain versions) with grad_reduce bf16x2
against the JAX package's "pallas" in interpret mode, iterations 991-994
(the densify that grows the pool, with mercy, at 992), under the same
checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_mercy import _JScene
from test_torch_sh_culling import pool_leaves, torch_cams
from test_training import target_scene

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.config import OptimizationParams as TOpt
from reduced3dgs_torch.models import gaussians as TG
from reduced3dgs_torch.train import trainer as T
from reduced3dgs_tpu.config import OptimizationParams as JOpt
from reduced3dgs_tpu.models import gaussians as JG
from reduced3dgs_tpu.ops import knn as jknn
from reduced3dgs_tpu.train.trainer import Trainer as JTrainer

FIRST, LAST = 991, 1006
BUDGET = 1024
SCHEDULE = dict(
    iterations=5000, densify_from_iter=0, densify_until_iter=1000,
    densification_interval=4, opacity_reset_interval=497, store_grads=True,
    prune_dead_points=True, mercy_points=True, mercy_interval=2,
    mercy_type="redundancy_random", lambda_mercy=0.5, mercy_minimum=2,
    box_size=2.0, lambda_sh_sparsity=0.1, lambda_alpha_regul=0.001,
    std_threshold=0.04, cdist_threshold=6.0)
CULL = (1002,)
SEED = 1
INT_STATS = ("n_points_cloned", "n_points_split", "n_points_pruned",
             "n_dropped_capacity", "n_points_mercied")


def _start_pool():
    """120 points in 128 slots at SH degree 2 (as after two degree steps)
    with view-dependent colour on half of them; the JAX pool."""
    rng = np.random.default_rng(42)
    pool = JG.create_from_pcd(
        rng.uniform(-0.9, 0.9, (120, 3)).astype(np.float32),
        rng.uniform(0.2, 0.8, (120, 3)).astype(np.float32), capacity=128)
    rest = np.zeros((128, 15, 3), np.float32)
    rest[:60, :8] = rng.normal(0, 0.4, (60, 8, 3))
    return pool._replace(
        params=pool.params._replace(features_rest=jnp.asarray(rest)),
        degrees=jnp.where(pool.alive, 2, 0).astype(jnp.int32),
        active_sh_degree=jnp.asarray(2, jnp.int32))


def _documented_knn_indices(points, k, **kw):
    """reduced3dgs_tpu/ops/knn.py's documented contract by numpy brute
    force: +inf rows are absent, never a neighbour while a real point is
    left (then they fill the list, and the query never does).  The JAX
    brute force breaks it (|q|^2 - 2 q.c + |c|^2 gives inf - inf = NaN;
    ROADMAP queue 3 item 1), so the JAX trainer's mercy pass runs on these
    lists, the port's own kNN's."""
    pts = np.asarray(points, np.float64)
    real = np.isfinite(pts).all(1)
    with np.errstate(invalid="ignore"):
        d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    d = np.where(real[:, None] & real[None, :], d, 1e300)
    np.fill_diagonal(d, np.inf)
    return jnp.asarray(np.argsort(d, axis=1, kind="stable")[:, :k],
                       jnp.int32)


class _JaxDraws:
    """The JAX trainer's key chain, replayed for the port: each densify
    and mercy pass splits it as the JAX trainer does and draws the same
    normals / coin flips."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.calls = []

    def _sub(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def densify_step(self, state, *a, **kw):
        cap = state.pool.capacity
        kw["normals"] = torch.as_tensor(np.array(
            jax.random.normal(self._sub(), (2, cap, 3))))
        self.calls.append(("densify", cap))
        return self.real_densify(state, *a, **kw)

    def mercy_step(self, state, counts, **kw):
        cap = state.pool.capacity
        kw["uniform"] = torch.as_tensor(np.array(
            jax.random.uniform(self._sub(), (cap,))))
        self.calls.append(("mercy", cap))
        return self.real_mercy(state, counts, **kw)


def test_trainer_loop_matches_jax_through_every_event(monkeypatch):
    jcams = target_scene()
    tcams = torch_cams(jcams)
    jpool = _start_pool()
    leaves = pool_leaves(jpool)
    jtr = JTrainer(jpool, dataclasses.replace(JOpt(), **SCHEDULE), jcams,
                   spatial_lr_scale=3.0, background=jnp.zeros(3),
                   backend="xla", initial_budget=BUDGET, seed=SEED,
                   cull_sh_iterations=CULL, scene=_JScene(jcams))
    ttr = T.Trainer(TG.pool_from_numpy(leaves, "cpu"),
                    dataclasses.replace(TOpt(), **SCHEDULE), tcams,
                    spatial_lr_scale=3.0, background=torch.zeros(3),
                    backend="ref", initial_budget=BUDGET, seed=SEED,
                    cull_sh_iterations=CULL)
    jtr.extent = ttr.extent = 3.0
    draws = _JaxDraws(SEED)
    draws.real_densify, draws.real_mercy = T.densify_step, T.mercy_step
    monkeypatch.setattr(T, "densify_step", draws.densify_step)
    monkeypatch.setattr(T, "mercy_step", draws.mercy_step)
    monkeypatch.setattr(jknn, "knn_indices", _documented_knn_indices)

    for it in range(FIRST, LAST + 1):
        jm = jtr.step(it)
        tm = ttr.step(it)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=str(it))
        assert abs(int(tm["num_rendered"]) - int(jm["num_rendered"])) <= 2
        tp, jp = ttr.state.pool, jtr.state.pool
        assert tp.capacity == jp.capacity, it
        np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive),
                                      err_msg=str(it))
        np.testing.assert_array_equal(tp.degrees.numpy(),
                                      np.asarray(jp.degrees),
                                      err_msg=str(it))
        assert tp.active_sh_degree == int(jp.active_sh_degree), it
        assert sorted(ttr.stats) == sorted(jtr.stats), it
        for k in INT_STATS:
            assert ttr.stats.get(k) == jtr.stats.get(k), (it, k)
        for k in ("redundancy_threshold", "opacity_threshold"):
            if k in jtr.stats:
                np.testing.assert_allclose(ttr.stats[k], jtr.stats[k],
                                           rtol=2e-3, err_msg=str(it))

    # every event ran, and the growth and the degree step happened
    assert ttr.events == {"densify": 2, "reset": 1, "prune_dead": 2,
                          "mercy": 2, "cull": 1}
    assert draws.calls == [("densify", 1024), ("mercy", 1024),
                           ("densify", 1024), ("mercy", 1024)]
    np.testing.assert_array_equal(np.asarray(draws.key),
                                  np.asarray(jtr.state.key))
    assert ttr.state.pool.active_sh_degree == 3
    assert ttr.stats["n_points_mercied"] > 0
    deg = ttr.state.pool.degrees.numpy()[ttr.state.pool.alive.numpy()]
    # the cull left degree 2 on view-dependent rows, 0 on the others
    assert {0, 2} <= set(np.unique(deg).tolist()) <= {0, 1, 2}
    for name, a, b in zip(T.GaussianParams._fields, ttr.state.pool.params,
                          jtr.state.pool.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=0, err_msg=name)
    assert list(ttr.state.opt.step) == [
        int(s) for s in jax.tree.leaves(jtr.state.opt.step)]


def test_bf16x2_loop_matches_jax_around_a_densify(monkeypatch):
    """The same start on the training default: the port's "tile" backend
    (the kernels' plain versions) with grad_reduce bf16x2 against the JAX
    package's "pallas" (interpret mode), iterations 991-994: a densify
    with store_grads that grows the pool, and a mercy pass, at 992."""
    jcams = target_scene()
    tcams = torch_cams(jcams)
    jpool = _start_pool()
    leaves = pool_leaves(jpool)
    kw = dict(spatial_lr_scale=3.0, initial_budget=BUDGET, seed=SEED,
              grad_reduce="bf16x2")
    jtr = JTrainer(jpool, dataclasses.replace(JOpt(), **SCHEDULE), jcams,
                   background=jnp.zeros(3), backend="pallas",
                   scene=_JScene(jcams), **kw)
    ttr = T.Trainer(TG.pool_from_numpy(leaves, "cpu"),
                    dataclasses.replace(TOpt(), **SCHEDULE), tcams,
                    background=torch.zeros(3), backend="tile", **kw)
    jtr.extent = ttr.extent = 3.0
    draws = _JaxDraws(SEED)
    draws.real_densify, draws.real_mercy = T.densify_step, T.mercy_step
    monkeypatch.setattr(T, "densify_step", draws.densify_step)
    monkeypatch.setattr(T, "mercy_step", draws.mercy_step)
    monkeypatch.setattr(jknn, "knn_indices", _documented_knn_indices)
    for it in range(991, 995):
        jm = jtr.step(it)
        tm = ttr.step(it)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=str(it))
        assert abs(int(tm["num_rendered"]) - int(jm["num_rendered"])) <= 2
        np.testing.assert_array_equal(ttr.state.pool.alive.numpy(),
                                      np.asarray(jtr.state.pool.alive),
                                      err_msg=str(it))
        for k in INT_STATS:
            assert ttr.stats.get(k) == jtr.stats.get(k), (it, k)
    assert ttr.events["densify"] == ttr.events["mercy"] == 1
    assert ttr.state.pool.capacity == jtr.state.pool.capacity == 1024
    for name, a, b in zip(T.GaussianParams._fields, ttr.state.pool.params,
                          jtr.state.pool.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=0, err_msg=name)
