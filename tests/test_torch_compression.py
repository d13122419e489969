"""Port parity: codebook quantisation (ops/kmeans.py), the four stored
PLY variants of the final compression, and ragged variable-SH rendering
(models/variable_sh.py).

* ``_assign``: ids equal (ties go to the lowest index in both);
* ``_quantile_init``: within 1e-6 (the same sorted values and the same
  f32 arithmetic for the uniform half);
* ``kmeans_1d`` at a fixed small iteration count: centres rtol 1e-5 (f32
  segment sums in another order), ids equal where the value is not within
  1e-6 of a boundary between two centres;
* the full fit: the criteria of tests/test_compression.py:33-60 (mean
  quantisation error; reconstruction of opacity and scaling), and against
  the JAX fit: reconstructed values within 2e-3 of each other on alive
  rows (the two fits stop at Lloyd steps that may differ by rounding);
* the four PLYs written by the port from one set of codebooks and by the
  JAX package from the same codebooks: loaded arrays equal; renders of
  the port's files within one 8-bit level of JAX renders of the JAX files;
* ``build_ragged`` / ``eval_colors``: the reordered pool and blocks equal
  to the JAX package's, colours rtol 1e-5, and the ragged render within
  2e-5 of the dense one (tests/test_sh.py:109).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_compression import make_pool
from test_torch_sh_culling import to_torch_pool

from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.models import ply_io as tply
from reduced3dgs_torch.models import variable_sh as tvsh
from reduced3dgs_torch.ops import kmeans as tkm
from reduced3dgs_torch.renderer import render as trender
from reduced3dgs_torch.scene import ply_name
from reduced3dgs_torch.train.__main__ import FINAL_VARIANTS
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.models import ply_io as jply
from reduced3dgs_tpu.models import variable_sh as jvsh
from reduced3dgs_tpu.ops import kmeans as jkm
from reduced3dgs_tpu.renderer import render as jrender


def test_assign_ids_equal():
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, 70_000).astype(np.float32)  # > one chunk
    centers = rng.normal(0, 1, 256).astype(np.float32)  # unsorted
    centers[17] = centers[200]  # a duplicate: the lowest index wins
    vals[:5] = centers[200]
    want = np.asarray(jkm._assign(jnp.asarray(vals), jnp.asarray(centers)))
    got = tkm._assign(torch.as_tensor(vals), torch.as_tensor(centers))
    assert got.dtype == torch.int64 and got.shape == (70_000,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:5] == 17).all()


@pytest.mark.parametrize("n_alive", [5000, 40, 1])
def test_quantile_init_matches_jax(n_alive):
    rng = np.random.default_rng(1)
    flat = rng.normal(0, 2, 6000).astype(np.float32)
    w = np.zeros(6000, np.float32)
    w[rng.permutation(6000)[:n_alive]] = 1.0
    want = np.asarray(jkm._quantile_init(jnp.asarray(flat), jnp.asarray(w),
                                         256))
    got = tkm._quantile_init(torch.as_tensor(flat), torch.as_tensor(w), 256)
    assert got.shape == (256,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    live = flat[w > 0]
    assert got.min() >= live.min() and got.max() <= live.max()


def _mixture(seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(m, 0.05, 2000)
                           for m in (-2, 0, 3)]).astype(np.float32)


@pytest.mark.parametrize("steps", [1, 3])
def test_kmeans_fixed_steps_match_jax(steps):
    vals = _mixture()
    rng = np.random.default_rng(2)
    w = (rng.uniform(size=vals.size) < 0.8).astype(np.float32)
    init = vals[rng.integers(0, vals.size, 16)]
    jids, jc = jkm.kmeans_1d(jnp.asarray(vals), jnp.asarray(init), 0.0,
                             num_clusters=16, max_iterations=steps,
                             weights=jnp.asarray(w))
    ids, c, it = tkm.kmeans_1d(
        torch.as_tensor(vals), torch.as_tensor(init), 0.0, num_clusters=16,
        max_iterations=steps, weights=torch.as_tensor(w),
        return_iterations=True)
    assert it == steps
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-7)
    # ids equal away from the boundaries between centres
    d = np.sort(np.abs(vals[:, None] - np.asarray(jc)[None]), axis=1)
    clear = d[:, 1] - d[:, 0] > 1e-6
    assert clear.mean() > 0.999
    np.testing.assert_array_equal(ids.numpy()[clear], np.asarray(jids)[clear])


def test_kmeans_full_fit():
    """tests/test_compression.py:33: the quantisation error is far below
    the cluster spread; empty clusters keep their centre; the fit stops
    on the tolerance."""
    vals = _mixture()
    init = np.concatenate([vals[np.random.default_rng(0).integers(
        0, 6000, 7)], [50.0]]).astype(np.float32)  # one centre out of reach
    ids, centers, it = tkm.kmeans_1d(
        torch.as_tensor(vals), torch.as_tensor(init), 1e-4, num_clusters=8,
        return_iterations=True)
    assert float((torch.as_tensor(vals) - centers[ids]).abs().mean()) < 0.05
    assert ids.dtype == torch.int64 and int(ids.max()) < 8
    assert float(centers[7]) == 50.0 and not (ids == 7).any()
    assert 1 <= it < tkm.MAX_ITERATIONS
    jids, jc = jkm.kmeans_1d(jnp.asarray(vals), jnp.asarray(init), 1e-4,
                             num_clusters=8)
    np.testing.assert_allclose(centers.numpy(), np.asarray(jc), rtol=1e-4)


def test_kmeans_stops_at_the_jax_step():
    """The port's fit stops at the Lloyd step where the JAX while_loop
    stops, on rows whose last step still moves the centres (by less than
    the tolerance): the JAX fit capped at the port's step count k gives
    the unlimited fit's centres, capped at k - 1 it does not."""
    rng = np.random.default_rng(3)
    vals = rng.laplace(size=8000).astype(np.float32)
    w = (rng.uniform(size=vals.size) < 0.9).astype(np.float32)
    tv, tw = torch.as_tensor(vals), torch.as_tensor(w)
    init = tkm._quantile_init(tv, tw, 64)
    kw = dict(num_clusters=64, weights=tw, return_iterations=True)
    _, c, k = tkm.kmeans_1d(tv, init, 1e-3, **kw)
    _, c_before, _ = tkm.kmeans_1d(tv, init, 1e-3, max_iterations=k - 1,
                                   **kw)
    assert 1 < k < 100
    assert 0.0 < float((c - c_before).abs().sum()) < 1e-3
    fits = {m: np.asarray(jkm.kmeans_1d(
        jnp.asarray(vals), jnp.asarray(init.numpy()), 1e-3, num_clusters=64,
        max_iterations=m, weights=jnp.asarray(w))[1])
        for m in (tkm.MAX_ITERATIONS, k, k - 1)}
    np.testing.assert_array_equal(fits[k], fits[tkm.MAX_ITERATIONS])
    assert not np.array_equal(fits[k - 1], fits[tkm.MAX_ITERATIONS])
    np.testing.assert_allclose(c.numpy(), fits[k], rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def pools():
    jpool = make_pool()
    return jpool, to_torch_pool(jpool)


@pytest.fixture(scope="module")
def books(pools):
    jpool, tpool = pools
    steps = {}
    tcb = tkm.produce_clusters(tpool, stats=steps)
    jcb = jkm.produce_clusters(jpool, jax.random.PRNGKey(0))
    return tcb, jcb, steps


def test_produce_clusters_reconstructs(pools, books):
    jpool, tpool = pools
    tcb, jcb, steps = books
    assert list(tcb) == list(jcb) and len(tcb) == 20
    assert list(steps) == list(tcb)
    assert all(1 <= v <= tkm.MAX_ITERATIONS for v in steps.values())
    alive = tpool.alive.numpy()
    for name, cb in tcb.items():
        assert cb.ids.dtype == torch.uint8, name
        assert cb.ids.shape == tuple(jcb[name].ids.shape), name
        assert cb.centers.shape == (256, 1), name
        assert bool(torch.isfinite(cb.centers).all()), name
    # tests/test_compression.py:46-60
    deq = tcb["opacity"].evaluate().reshape(-1).numpy()[alive]
    raw = tpool.params.opacity[:, 0].numpy()[alive]
    assert np.abs(deq - raw).mean() < 0.05
    rec = tkm.apply_clustering(tpool, tcb)
    jrec = jkm.apply_clustering(jpool, jcb)
    ds = (rec.params.scaling - tpool.params.scaling).abs().numpy()[alive]
    assert ds.mean() < 0.1
    # against the JAX fit, leaf by leaf, on alive rows
    for name in ("features_dc", "features_rest", "scaling", "rotation",
                 "opacity"):
        np.testing.assert_allclose(
            getattr(rec.params, name).numpy()[alive],
            np.asarray(getattr(jrec.params, name))[alive], atol=2e-3,
            rtol=0, err_msg=name)
    np.testing.assert_array_equal(rec.params.xyz.numpy(),
                                  np.asarray(jpool.params.xyz))


def test_produce_clusters_degenerate_small_pool():
    """tests/test_compression.py:63: alive << clusters and a saturated
    opacity logit: every live value lands on its own centre, and the
    inverse-activated centres stay finite."""
    jpool = make_pool(n=14, cap=1024, seed=3)
    jpool = jpool._replace(params=jpool.params._replace(
        opacity=jpool.params.opacity.at[0, 0].set(32.0)))
    tpool = to_torch_pool(jpool)
    cb = tkm.produce_clusters(tpool)
    for name, c in cb.items():
        assert bool(torch.isfinite(c.centers).all()), name
    rec = tkm.apply_clustering(tpool, cb)
    alive = tpool.alive.numpy()
    ds = (rec.params.scaling - tpool.params.scaling).abs().numpy()[alive]
    assert ds.max() < 1e-3
    so = torch.sigmoid(tpool.params.opacity).numpy()[alive]
    sr = torch.sigmoid(rec.params.opacity).numpy()[alive]
    assert np.abs(so - sr).max() < 1e-3
    rot = tpool.get_rotation().numpy()
    assert np.abs(rec.params.rotation.numpy() - rot)[alive].max() < 1e-3


def test_codebooks_from_numpy_round_trip(books):
    tcb, jcb, _ = books
    got = tkm.codebooks_from_numpy(
        {k: (np.asarray(v.ids), np.asarray(v.centers))
         for k, v in jcb.items()}, "cpu")
    for name, cb in got.items():
        assert cb.ids.dtype == torch.uint8 and cb.centers.shape == (256, 1)
        np.testing.assert_array_equal(cb.ids.numpy(),
                                      np.asarray(jcb[name].ids))
        np.testing.assert_array_equal(
            cb.evaluate().numpy(), np.asarray(jcb[name].evaluate()))
    again = tkm.codebooks_from_numpy(tcb, "cpu")  # Codebook objects too
    assert torch.equal(again["scaling"].ids, tcb["scaling"].ids)


def _variant_kwargs(quantise, half_float, pack_xyz):
    save = dict(quantised=quantise, half_float=half_float,
                xyz_codec="u16c" if pack_xyz else None)
    load = dict(quantised=quantise, half_float=half_float)
    return save, load


@pytest.mark.parametrize("variant", FINAL_VARIANTS,
                         ids=lambda v: ply_name(*v))
def test_four_plys_match_jax_files(pools, books, variant, tmp_path):
    """The same codebooks (the JAX fit's, through codebooks_from_numpy)
    saved by both packages: every loaded array equal, and renders within
    one 8-bit level."""
    jpool, tpool = pools
    _, jcb, _ = books
    tcb = tkm.codebooks_from_numpy(jcb, "cpu")
    save_kw, load_kw = _variant_kwargs(*variant)
    quantised = variant[0]
    jpath = os.path.join(tmp_path, "jax", ply_name(*variant))
    tpath = os.path.join(tmp_path, "torch", ply_name(*variant))
    jply.save_gaussian_ply(jpath, jpool, jcb if quantised else None,
                           **save_kw)
    tply.save_gaussian_ply(tpath, tpool, tcb if quantised else None,
                           **save_kw)
    assert os.path.getsize(tpath) == os.path.getsize(jpath)
    want = jply.load_gaussian_ply(jpath, **load_kw)
    got = tply.load_gaussian_ply(tpath, **load_kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    tp = tply.pool_from_arrays(got, "cpu")
    jp = jply.pool_from_arrays(want)
    jcam = JCamera.look_at(eye=(0, 0.3, -5), target=(0, 0, 0), width=64,
                           height=48)
    tcam = TCamera.look_at(eye=(0, 0.3, -5), target=(0, 0, 0), width=64,
                           height=48)
    jout = jrender(jp.params.xyz, jp.features(), jp.params.scaling,
                   jp.params.rotation, jp.params.opacity[:, 0], jp.degrees,
                   jcam.params(), jnp.zeros(3), width=64, height=48,
                   instance_budget=8192, alive_mask=jp.alive,
                   backend="pallas")
    with torch.inference_mode():
        tout = trender(tp.params.xyz, tp.features(), tp.params.scaling,
                       tp.params.rotation, tp.params.opacity[:, 0],
                       tp.degrees, tcam.params("cpu"), torch.zeros(3),
                       width=64, height=48, instance_budget=8192,
                       alive_mask=tp.alive)
    a = (np.clip(tout.color.numpy(), 0, 1) * 255).astype(np.uint8)
    b = (np.clip(np.asarray(jout.color), 0, 1) * 255).astype(np.uint8)
    assert b.max() > 50
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_final_compression_writes_the_four_files(pools, tmp_path):
    """The training CLI's final step on a stub scene: four files by the
    reference's names, each loading to the alive count, the half-float
    one the smallest, and the statistics a caller can print."""
    from reduced3dgs_torch.scene import Scene
    from reduced3dgs_torch.train.__main__ import final_compression

    _, tpool = pools
    scene = Scene.__new__(Scene)
    scene.model_path, scene.pool = str(tmp_path), tpool
    stats = {}
    paths = final_compression(scene, 7, stats=stats)
    names = [os.path.basename(p) for p in paths]
    assert names == ["point_cloud.ply", "point_cloud_quantised.ply",
                     "point_cloud_quantised_half.ply",
                     "point_cloud_quantised_pack.ply"]
    assert all(os.path.dirname(p).endswith("iteration_7") for p in paths)
    n = int(tpool.num_alive)
    for p, (q, h, pack) in zip(paths, FINAL_VARIANTS):
        arrs = tply.load_gaussian_ply(p, quantised=q or pack,
                                      half_float=h or pack)
        assert arrs["xyz"].shape == (n, 3)
    size = stats["bytes"]
    # 200 primitives: the 20 KB of f32 centres outweigh the saving of the
    # uint8 ids, the f16 centres do not
    assert size["point_cloud_quantised.ply"] \
        > size["point_cloud_quantised_half.ply"]
    assert size["point_cloud.ply"] > size["point_cloud_quantised_half.ply"]
    assert len(stats["lloyd_steps"]) == 20 and stats["fit_s"] > 0


def _sh_pool():
    rng = np.random.default_rng(5)
    from reduced3dgs_tpu.models import gaussians as JG

    jpool = JG.create_from_pcd(
        rng.uniform(-1, 1, (120, 3)).astype(np.float32),
        rng.uniform(0, 1, (120, 3)).astype(np.float32), capacity=160)
    alive = np.asarray(jpool.alive).copy()
    alive[10:25] = False  # dead rows inside the live range
    return jpool._replace(
        params=jpool.params._replace(features_rest=jnp.asarray(
            rng.normal(0, 0.3, (160, 15, 3)).astype(np.float32))),
        degrees=jnp.asarray(rng.integers(0, 4, 160).astype(np.int32)),
        alive=jnp.asarray(alive))


def test_build_ragged_and_eval_colors_match_jax():
    jpool = _sh_pool()
    jp, jr = jvsh.build_ragged(jpool)
    tp, tr = tvsh.build_ragged(to_torch_pool(jpool))
    assert tr.sizes == jr.sizes and sum(tr.sizes) == int(jpool.alive.sum())
    for d, (a, b) in enumerate(zip(tr.blocks, jr.blocks)):
        assert a.shape == (tr.sizes[d], (d + 1) ** 2, 3)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tp.params, jp.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tp.degrees.numpy(), np.asarray(jp.degrees))
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    campos = np.array([0.2, -0.1, -3.0], np.float32)
    want = np.asarray(jvsh.eval_colors(jr, jp.params.xyz,
                                       jnp.asarray(campos)))
    got = tvsh.eval_colors(tr, tp.params.xyz, torch.as_tensor(campos))
    assert got.shape == (160, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not got[sum(tr.sizes):].any()


def test_ragged_render_matches_dense():
    """tests/test_sh.py:109 on the port, through render.PoolView as the
    render CLI's --variable_sh_bands does it."""
    from reduced3dgs_torch.render import PoolView, render_once

    tpool = to_torch_pool(_sh_pool())
    cp = TCamera.look_at(eye=(0, 0, -3), target=(0, 0, 0), width=64,
                         height=48).params("cpu")
    bg = torch.zeros(3)
    dense = render_once(PoolView(tpool), cp, bg, 4096)
    pv = PoolView(tpool, variable_sh=True)
    assert pv.features.shape == (160, 1, 3) and pv.ragged is not None
    rag = render_once(pv, cp, bg, 4096)
    assert int(rag.num_rendered) == int(dense.num_rendered) > 100
    np.testing.assert_allclose(rag.color.numpy(), dense.color.numpy(),
                               atol=2e-5)
