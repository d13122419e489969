"""Port parity of the training step's host-free parts, torch vs JAX:
losses, Adam and its learning-rate schedule, the 3-NN scale init, the
densify surgery, and one whole f32 train step.

Tolerances:
* l1 / psnr / ssim (and ssim's gradient): rtol 1e-5 (float32 in another
  summation order);
* Adam on identical gradients and expon_lr: 1e-6 relative;
* mean_knn_dist2: rtol 1e-5;
* densify: the pool's integer / bool leaves exactly, float leaves to
  rtol 1e-6 (the split children go through exp / log / a 3x3 rotation);
* one train step: loss within 1e-6 relative; gradients at the render
  tolerance (atol 2e-4 * max|g|, rtol 2e-3); parameters and Adam moments
  within 1e-5 of each leaf's max on the rows whose gradient is above that
  tolerance (on the others a rounding-level gradient whose sign differs
  between the frameworks moves a parameter by a full learning rate at
  step 1, so they are not comparable).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tile_render import BUDGET, H, W, make_scene

from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.config import OptimizationParams as TOpt
from reduced3dgs_torch.models import gaussians as TG
from reduced3dgs_torch.ops import knn as tknn
from reduced3dgs_torch.ops import losses as tloss
from reduced3dgs_torch.renderer import render as trender
from reduced3dgs_torch.train import adam as tadam
from reduced3dgs_torch.train import trainer as ttrainer
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.config import OptimizationParams as JOpt
from reduced3dgs_tpu.models import gaussians as JG
from reduced3dgs_tpu.ops import knn as jknn
from reduced3dgs_tpu.ops import losses as jloss
from reduced3dgs_tpu.train import adam as jadam
from reduced3dgs_tpu.train import trainer as jtrainer

EYE = (0.3, -0.2, -3.2)
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta = torch.as_tensor(a).requires_grad_(True)
    tb = torch.as_tensor(b)
    for jf, tf_ in ((jloss.l1_loss, tloss.l1_loss),
                    (jloss.psnr, tloss.psnr)):
        np.testing.assert_allclose(float(tf_(ta.detach(), tb)),
                                   float(jf(ja, jb)),
                                   rtol=1e-5)
    s = tloss.ssim(ta, tb)
    np.testing.assert_allclose(float(s), float(jloss.ssim(ja, jb)),
                               rtol=1e-5)
    (g,) = torch.autograd.grad(s, [ta])
    want = np.asarray(jax.grad(lambda x: jloss.ssim(x, jb))(ja))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _params(rng, c):
    return {k: rng.normal(0, 1, (c,) + s).astype(np.float32)
            for k, s in TG._PARAM_SHAPES.items()}


def test_adam_and_expon_lr_match_jax():
    """Three steps on identical gradients, one leaf skipped at step 2."""
    rng = np.random.default_rng(1)
    c = 64
    p = _params(rng, c)
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = TG.GaussianParams(**{k: torch.as_tensor(v) for k, v in p.items()})
    jst, tst = jadam.init(jp), tadam.init(tp)
    jupd = jax.jit(jadam.update)
    lrs = [0.01, 0.002, 0.05, 0.005, 0.001, 0.05]
    for step in range(3):
        g = _params(rng, c)
        skip = [step == 1 and k == "opacity" for k in LEAVES]
        jp, jst = jupd(
            jp, JG.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in g.items()}), jst,
            JG.GaussianParams(*(jnp.float32(x) for x in lrs)),
            skip_tree=JG.GaussianParams(*skip))
        tp, tst = tadam.update(
            tp, TG.GaussianParams(**{k: torch.as_tensor(v)
                                     for k, v in g.items()}), tst,
            TG.GaussianParams(*lrs), skip_tree=TG.GaussianParams(*skip))
    for tree_j, tree_t in ((jp, tp), (jst.mu, tst.mu), (jst.nu, tst.nu)):
        for k, a, b in zip(LEAVES, tree_j, tree_t):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max(),
                                       err_msg=k)
    assert list(tst.step) == [int(s) for s in jst.step] == [3] * 5 + [2]
    for it in (0, 1, 7, 500, 14_999, 30_000, 40_000):
        want = float(jadam.expon_lr(jnp.float32(it), 0.00016 * 3.7,
                                    0.0000016 * 3.7, lr_delay_mult=0.01,
                                    max_steps=30_000))
        got = tadam.expon_lr(it, 0.00016 * 3.7, 0.0000016 * 3.7,
                             lr_delay_mult=0.01, max_steps=30_000)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mean_knn_dist2_matches_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(0, 0.3, (300, 3)),
                          rng.uniform(-2, 2, (200, 3))]).astype(np.float32)
    pts[10] = pts[11]  # a duplicate point: distance 0
    want = np.asarray(jknn.mean_knn_dist2(jnp.asarray(pts), exact=True))
    got = tknn.mean_knn_dist2(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def _pool_leaves(seed=4, c=256, n=150):
    """A training pool with statistics that make densify clone, split
    and prune, as numpy leaves."""
    rng = np.random.default_rng(seed)
    leaves = _params(rng, c)
    leaves["scaling"] = np.log(rng.uniform(0.001, 0.2, (c, 3))).astype(
        np.float32)
    leaves["degrees"] = rng.integers(0, 4, c).astype(np.int32)
    leaves["alive"] = np.arange(c) < n
    leaves["max_radii2d"] = rng.uniform(0, 30, c).astype(np.float32)
    leaves["xyz_grad_accum"] = rng.uniform(0, 2e-3, c).astype(np.float32)
    leaves["denom"] = rng.integers(0, 5, c).astype(np.float32)
    leaves["opacity"][:10] = -7.0  # sigmoid below 0.005: pruned
    return leaves


def _jax_pool(leaves):
    p = JG.GaussianParams(**{k: jnp.asarray(leaves[k]) for k in LEAVES})
    zeros = np.zeros(len(leaves["alive"]), np.float32)
    return JG.GaussianPool(
        params=p, degrees=jnp.asarray(leaves["degrees"]),
        alive=jnp.asarray(leaves["alive"]),
        **{k: jnp.asarray(leaves.get(k, zeros))
           for k in ("max_radii2d", "xyz_grad_accum", "denom")},
        active_sh_degree=jnp.int32(leaves.get("active_sh_degree", 0)))


def test_densify_matches_jax():
    """densify_and_prune (clone, split with the JAX key's normal draws,
    prune, statistics reset) and the Adam row surgery on the same pool."""
    leaves = _pool_leaves()
    cfg = dataclasses.replace(JOpt(), percent_dense=0.02,
                              densify_grad_threshold=2e-4)
    jpool = _jax_pool(leaves)
    rng = np.random.default_rng(6)
    moments = [_params(rng, jpool.capacity) for _ in range(2)]
    jopt = jadam.AdamState(
        mu=JG.GaussianParams(**{k: jnp.asarray(v)
                                for k, v in moments[0].items()}),
        nu=JG.GaussianParams(**{k: jnp.asarray(v)
                                for k, v in moments[1].items()}),
        step=JG.GaussianParams(*(jnp.int32(5) for _ in LEAVES)))
    key = jax.random.PRNGKey(3)
    jst, jstats = jtrainer.densify_step(
        jtrainer.TrainState(jpool, jopt, key), jnp.float32(2.5),
        opt_cfg=cfg, use_size_threshold=True)
    normals = np.asarray(jax.random.normal(jax.random.split(key)[1],
                                           (2, jpool.capacity, 3)))

    tpool = TG.pool_from_numpy(leaves, "cpu")
    topt = tadam.AdamState(
        mu=TG.GaussianParams(**{k: torch.as_tensor(v)
                                for k, v in moments[0].items()}),
        nu=TG.GaussianParams(**{k: torch.as_tensor(v)
                                for k, v in moments[1].items()}),
        step=TG.GaussianParams(*(5 for _ in LEAVES)))
    tst, tstats = ttrainer.densify_step(
        ttrainer.TrainState(tpool, topt, torch.Generator()), 2.5,
        opt_cfg=TOpt(percent_dense=0.02, densify_grad_threshold=2e-4),
        use_size_threshold=True, normals=torch.as_tensor(normals))
    for k in ("n_points_cloned", "n_points_split", "n_points_pruned",
              "n_dropped_capacity"):
        assert int(tstats[k]) == int(jstats[k]), k
    assert all(int(jstats[k]) > 0 for k in ("n_points_cloned",
                                            "n_points_split",
                                            "n_points_pruned"))
    jp, tp = jst.pool, tst.pool
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    np.testing.assert_array_equal(tp.degrees.numpy(),
                                  np.asarray(jp.degrees))
    pairs = list(zip(jp.params, tp.params)) + list(zip(
        jst.opt.mu, tst.opt.mu)) + list(zip(jst.opt.nu, tst.opt.nu))
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), 0.0)


@pytest.fixture(scope="module")
def step_inputs():
    """Student pool (make_scene with dead slots and clamped opacities) and
    a ground-truth image rendered by the port from another scene."""
    xyz, feats, scales, rots, opac, deg = (np.asarray(a) for a in
                                           make_scene(seed=5))
    n, c = xyz.shape[0], 512
    leaves = {k: np.zeros((c,) + s, np.float32)
              for k, s in TG._PARAM_SHAPES.items()}
    leaves["rotation"][:, 0] = 1.0
    for k, v in (("xyz", xyz), ("features_dc", feats[:, :1]),
                 ("features_rest", feats[:, 1:]), ("scaling", scales),
                 ("rotation", rots), ("opacity", opac[:, None])):
        leaves[k][:n] = v
    leaves["opacity"][:20] = 5.5  # alpha clamp engages
    leaves["degrees"] = np.zeros(c, np.int32)
    leaves["degrees"][:n] = deg
    leaves["alive"] = np.arange(c) < n
    gt_arrs = [torch.as_tensor(np.asarray(a)) for a in make_scene(seed=9)]
    cam = TCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    with torch.no_grad():
        gt = trender(*gt_arrs, cam.params("cpu"), torch.zeros(3), width=W,
                     height=H, instance_budget=BUDGET).color
    return leaves, np.clip(gt.numpy(), 0, 1)


def test_train_step_matches_jax(step_inputs):
    """One f32-mode train step from the same state: the JAX train_step
    (pallas backend, Pallas in interpret mode) against the port's
    train_step (tile backend, plain kernel versions)."""
    leaves, gt = step_inputs
    it, slr = 7, 2.5
    cfg = dataclasses.replace(JOpt(), lambda_alpha_regul=0.01,
                              lambda_sh_sparsity=0.01)
    tcfg = TOpt(lambda_alpha_regul=0.01, lambda_sh_sparsity=0.01)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    jpool = _jax_pool(leaves)
    jcam = JCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    jst = jtrainer.TrainState(jpool, jadam.init(jpool.params),
                              jax.random.PRNGKey(0))
    jst2, jm, jg = jtrainer.train_step(
        jst, jcam.params(), jnp.asarray(gt), jnp.asarray(bg),
        jnp.int32(it), width=W, height=H, budget=BUDGET, backend="pallas",
        opt_cfg=cfg, spatial_lr_scale=slr, skip_update=True,
        grad_reduce="f32")
    lr = jtrainer.make_lr_tree(jg, cfg, jtrainer._xyz_lr(
        jnp.int32(it), cfg, slr))
    jparams, jopt = jax.jit(jadam.update)(jpool.params, jg, jst.opt, lr)

    tpool = TG.pool_from_numpy(leaves, "cpu")
    tcam = TCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    tst = ttrainer.TrainState(tpool, tadam.init(tpool.params),
                              torch.Generator())
    kw = dict(width=W, height=H, budget=BUDGET, backend="tile",
              opt_cfg=tcfg, spatial_lr_scale=slr, grad_reduce="f32")
    args = (tst, tcam.params("cpu"), torch.as_tensor(gt),
            torch.as_tensor(bg), it)
    _, tm, tg = ttrainer.train_step(*args, skip_update=True, **kw)
    tst2, tm2 = ttrainer.train_step(*args, **kw)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    assert float(tm2["loss"]) == float(tm["loss"])
    assert int(tm["num_rendered"]) == int(jm["num_rendered"]) > 300
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        a = np.asarray(getattr(jst2.pool, k))
        np.testing.assert_allclose(getattr(tst2.pool, k).numpy(), a,
                                   rtol=2e-3, atol=2e-4 * np.abs(a).max(),
                                   err_msg=k)
    for k, ga, gb, pa, pb, ma, mb, va, vb in zip(
            LEAVES, jg, tg, jparams, tst2.pool.params, jopt.mu,
            tst2.opt.mu, jopt.nu, tst2.opt.nu):
        ga = np.asarray(ga)
        gb = gb.numpy()
        tol = 2e-4 * np.abs(ga).max()
        np.testing.assert_allclose(gb, ga, atol=tol, rtol=2e-3,
                                   err_msg=f"grad {k}")
        rows = (np.abs(ga) > tol).reshape(ga.shape[0], -1).all(axis=1)
        assert rows.sum() > 10, k
        for name, a, b in (("param", pa, pb), ("mu", ma, mb),
                           ("nu", va, vb)):
            a = np.asarray(a)[rows]
            np.testing.assert_allclose(
                b.numpy()[rows], a, rtol=0, atol=1e-5 * np.abs(a).max(),
                err_msg=f"{name} {k}")
    assert list(tst2.opt.step) == [int(s) for s in jopt.step]
