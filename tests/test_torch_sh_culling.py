"""Port parity: adaptive SH-band culling (ops/sh.py per-degree colours,
ops/sh_culling.py, and the cull at the end of ``Trainer.step``).

The same numpy pool goes through the JAX package ("pallas" in interpret
mode or the "xla" oracle, as tests/test_sh_culling.py runs it) and the
port ("tile" with the plain kernel versions, or "ref").  Tolerances:

* ``eval_sh_color_per_degree``: rtol 1e-5 (the same f32 sums);
* ``calculate_colours_variance``: rtol 1e-4 / atol 1e-5 (weights are
  ratios of transmittance sums that agree to ~1e-6), NaN in the same
  places;
* the culling passes and ``cull_sh_bands``: degrees equal, features within
  1e-5;
* one ``Trainer.step`` that ends in a cull: degrees equal, features within
  1e-5 of the JAX trainer's (the step before the cull is held to its own
  tolerances in tests/test_torch_train.py; the cull only reads colours).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sh_culling import make_pool_and_cams

from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.config import OptimizationParams as TOpt
from reduced3dgs_torch.models import gaussians as TG
from reduced3dgs_torch.ops import sh as tsh
from reduced3dgs_torch.ops import sh_culling as tcull
from reduced3dgs_torch.train import trainer as ttrainer
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.config import OptimizationParams as JOpt
from reduced3dgs_tpu.models import gaussians as JG
from reduced3dgs_tpu.ops import sh as jsh
from reduced3dgs_tpu.ops import sh_culling as jcull
from reduced3dgs_tpu.train import trainer as jtrainer

BACKENDS = {"tile": "pallas", "ref": "xla"}  # port backend -> JAX backend
THRESHOLD = 6 * math.sqrt(3) / 255.0
STD_THRESHOLD = 0.04


def pool_leaves(jpool):
    """A JAX pool's leaves as numpy arrays (for pool_from_numpy)."""
    leaves = {k: np.array(v) for k, v in jpool.params._asdict().items()}
    for k in ("degrees", "alive", "max_radii2d", "xyz_grad_accum", "denom"):
        leaves[k] = np.array(getattr(jpool, k))
    leaves["active_sh_degree"] = int(jpool.active_sh_degree)
    return leaves


def to_torch_pool(jpool):
    return TG.pool_from_numpy(pool_leaves(jpool), "cpu")


def torch_cams(jcams):
    """The port's cameras at the JAX cameras' poses."""
    return [TCamera(uid=c.uid, colmap_id=c.colmap_id, R=c.R, T=c.T,
                    fov_x=c.fov_x, fov_y=c.fov_y, image=c.image,
                    image_name=c.image_name, width=c.width, height=c.height)
            for c in jcams]


def same_pool(tpool, jpool, atol=1e-5):
    np.testing.assert_array_equal(tpool.degrees.numpy(),
                                  np.asarray(jpool.degrees))
    np.testing.assert_array_equal(tpool.alive.numpy(),
                                  np.asarray(jpool.alive))
    for name in ("features_dc", "features_rest"):
        np.testing.assert_allclose(
            getattr(tpool.params, name).numpy(),
            np.asarray(getattr(jpool.params, name)), atol=atol, rtol=0,
            err_msg=name)


def test_eval_sh_color_per_degree_matches_jax():
    rng = np.random.default_rng(2)
    sh = rng.normal(0, 0.5, (64, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    deg = rng.integers(0, 4, 64).astype(np.int32)
    want = np.asarray(jsh.eval_sh_color_per_degree(
        jnp.asarray(sh), jnp.asarray(dirs), jnp.asarray(deg)))
    got = tsh.eval_sh_color_per_degree(
        torch.as_tensor(sh), torch.as_tensor(dirs), torch.as_tensor(deg))
    assert got.shape == (64, 4, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # zeros above a primitive's own degree, clamped colours below it
    for d in range(4):
        assert not got[torch.as_tensor(deg) < d, d].any()
    assert float(got.min()) >= 0.0
    # the last emitted colour of a full-degree row is the render colour
    full = tsh.eval_sh_color_clamped(
        torch.as_tensor(sh), torch.as_tensor(dirs),
        torch.full((64,), 3, dtype=torch.int32))
    got3 = tsh.eval_sh_color_per_degree(
        torch.as_tensor(sh), torch.as_tensor(dirs),
        torch.full((64,), 3, dtype=torch.int32))
    np.testing.assert_allclose(got3[:, 3].numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_variance_stats_golden_two_primitives():
    """The golden 2-primitive, 2-camera case of
    tests/test_sh_culling.py:45 on the port: p0 isolated and seen by both
    cameras (w = 1 each), p1 of degree 1 seen by camera 0 and behind
    camera 1; the expected statistics are those the JAX package gives on
    the same pool (held there to an independent numpy transcription at
    atol 1e-5), and the padding rows divide 0 by 0."""
    rng = np.random.default_rng(7)
    pts = np.array([[0.0, 0.0, 0.0], [3.5, 0.0, 4.0]], np.float32)
    sh = rng.normal(0, 0.4, (2, 16, 3)).astype(np.float32)
    sh[:, 0] = rng.uniform(0.5, 1.5, (2, 3))
    jpool = JG.create_from_pcd(pts, np.full((2, 3), 0.5, np.float32),
                               capacity=8)
    jpool = jpool._replace(
        params=jpool.params._replace(
            features_dc=jpool.params.features_dc.at[:2].set(sh[:, :1]),
            features_rest=jpool.params.features_rest.at[:2].set(sh[:, 1:]),
            scaling=jpool.params.scaling.at[:2].set(np.log(0.08)),
            opacity=jpool.params.opacity.at[:2].set(3.0)),
        degrees=jpool.degrees.at[:2].set(jnp.asarray([3, 1], jnp.int32)),
        active_sh_degree=jnp.int32(3))
    jcams = [JCamera.look_at(eye=(0, 0, -3), target=(0, 0, 1), width=64,
                             height=64, uid=0),
             JCamera.look_at(eye=(3, 0, 0), target=(0, 0, 0), width=64,
                             height=64, uid=1)]
    want = [np.asarray(a) for a in jcull.calculate_colours_variance(
        jpool, jcams, budget=4096, backend="pallas")]
    got = [a.numpy() for a in tcull.calculate_colours_variance(
        to_torch_pool(jpool), torch_cams(jcams), budget=4096,
        backend="tile")]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g[:2], w[:2], atol=1e-5, rtol=0)
    dists = got[0]
    assert dists[1, 0] > 0.1  # distances against the zero "full" colour
    assert np.isnan(dists[2:]).all()  # never present: 0 / 0
    # p0 is alone at every pixel it touches: its weight is exactly 1 per
    # camera, so its mean is the plain mean of its two full colours
    cols = [tsh.eval_sh_color_per_degree(
        torch.as_tensor(sh[:1]), torch.as_tensor(
            (pts[0] - eye) / np.linalg.norm(pts[0] - eye))[None].float(),
        torch.tensor([3], dtype=torch.int32))[0, 3].numpy()
        for eye in (np.array([0, 0, -3.0]), np.array([3.0, 0, 0]))]
    np.testing.assert_allclose(got[2][0, 0], (cols[0] + cols[1]) / 2,
                               atol=1e-5)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_colours_variance_matches_jax(backend):
    jpool, jcams = make_pool_and_cams()
    want = jcull.calculate_colours_variance(
        jpool, jcams, budget=4096, backend=BACKENDS[backend])
    got = tcull.calculate_colours_variance(
        to_torch_pool(jpool), torch_cams(jcams), budget=4096,
        backend=backend)
    for g, w, name in zip(got, want, ("distances", "variance", "mean")):
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w),
                                      err_msg=name)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert np.isnan(got[0].numpy()).any()  # dead rows: 0 / 0
    assert np.isfinite(got[0].numpy()[np.asarray(jpool.alive)]).all()


def test_culling_passes_match_jax():
    """Each pass on the JAX package's statistics (so the passes are
    compared on identical inputs, NaNs included)."""
    jpool, jcams = make_pool_and_cams(seed=1)
    dists, var, mean = jcull.calculate_colours_variance(
        jpool, jcams, budget=4096, backend="xla")
    tpool = to_torch_pool(jpool)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731

    jp, jn = jcull.low_variance_colour_culling(jpool, STD_THRESHOLD, var,
                                               mean)
    tp, tn = tcull.low_variance_colour_culling(tpool, STD_THRESHOLD, t(var),
                                               t(mean))
    assert int(tn) == int(jn) > 0
    same_pool(tp, jp)
    jp2 = jcull.low_distance_colour_culling(jpool, THRESHOLD, dists, 3)
    tp2 = tcull.low_distance_colour_culling(tpool, THRESHOLD, t(dists), 3)
    same_pool(tp2, jp2, atol=0)
    deg = tp2.degrees.numpy()[np.asarray(jpool.alive)]
    assert 0 < (deg < 3).sum() < deg.size  # some demoted, not all
    assert tp2.degrees.dtype == torch.int32


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_cull_sh_bands_matches_jax(backend):
    jpool, jcams = make_pool_and_cams()
    want = jcull.cull_sh_bands(
        jpool, jcams, threshold=THRESHOLD, std_threshold=STD_THRESHOLD,
        budget=4096, backend=BACKENDS[backend])
    got = tcull.cull_sh_bands(
        to_torch_pool(jpool), torch_cams(jcams), threshold=THRESHOLD,
        std_threshold=STD_THRESHOLD, budget=4096, backend=backend)
    same_pool(got, want)
    alive = got.alive.numpy()
    deg = got.degrees.numpy()[alive]
    assert (deg[12:] < 3).all() and np.median(deg[:12]) >= 2
    rest = got.params.features_rest.numpy()[alive]
    for i, dg in enumerate(deg):
        assert not rest[i, (dg + 1) ** 2 - 1:].any()
    # the culled pool goes on training: no inference tensors in it
    assert not any(p.is_inference() for p in got.params)
    assert not got.degrees.is_inference()


def _trainer_pair(cull_at, **cfg_kw):
    jpool, jcams = make_pool_and_cams()
    rng = np.random.default_rng(3)
    for c in jcams:
        c.image = rng.uniform(0, 1, (c.height, c.width, 3)).astype(
            np.float32)
    tcams = torch_cams(jcams)
    kw = dict(iterations=10, densify_from_iter=100, std_threshold=0.04,
              cdist_threshold=6.0)
    kw.update(cfg_kw)
    jtr = jtrainer.Trainer(
        jpool, dataclasses.replace(JOpt(), **kw), jcams,
        spatial_lr_scale=3.0, background=np.zeros(3, np.float32),
        backend="pallas", initial_budget=4096, seed=1,
        cull_sh_iterations=cull_at)
    ttr = ttrainer.Trainer(
        to_torch_pool(jpool), dataclasses.replace(TOpt(), **kw), tcams,
        spatial_lr_scale=3.0, background=torch.zeros(3), backend="tile",
        initial_budget=4096, seed=1, cull_sh_iterations=cull_at)
    jtr.extent = ttr.extent = 3.0
    return jtr, ttr


def test_trainer_step_with_cull_matches_jax():
    jtr, ttr = _trainer_pair((1,))
    assert ttr.fine_tune_start == jtr.fine_tune_start == 10 - 3000
    assert ttr.cull_sh_iterations == (1,)
    jm = jtr.step(1)
    tm = ttr.step(1)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    same_pool(ttr.state.pool, jtr.state.pool)
    deg = ttr.state.pool.degrees.numpy()[ttr.state.pool.alive.numpy()]
    assert (deg < 3).any()
    ttr.step(2)  # the culled pool trains on
    assert list(ttr.state.opt.step) == [2] * 6


def test_trainer_without_cull_iterations_keeps_degrees():
    _, ttr = _trainer_pair(())
    assert ttr.fine_tune_start == 10
    before = ttr.state.pool.degrees.clone()
    ttr.step(1)
    assert torch.equal(ttr.state.pool.degrees, before)
