"""Port parity: mercy pruning — the redundancy metric
(ops/redundancy.py), the masked statistics and ``mercy_points``
(train/densify.py), and the mercy block of ``Trainer.step``.

* the three numpy checks of tests/test_redundancy.py:46-88 on the port
  (pixel size rtol 1e-3 / atol 1e-5 as there; masks and counts equal);
* ``redundancy_metric`` against the JAX package: the integer metric
  equal, the cube size rtol 2e-3 — the whole metric where the alive count
  is a power of two, and the core on the port's neighbour lists where the
  compacted view has absent (+inf) rows (there the JAX package's
  brute-force search forms inf - inf in its expanded distances and lists
  absent rows as neighbours of real points, which the port does not
  repeat: its lists are held to a numpy brute force instead);
* ``knn_exact`` with absent rows: the true neighbour sets, no NaN;
* ``masked_quantile`` / ``masked_median``: torch.quantile / torch.median
  of the masked subset within 1e-5 / 1e-6 (tests/test_densify.py:96,127);
* ``mercy_points`` for every mercy_type: alive masks equal, thresholds
  rtol 1e-5;
* a trainer schedule with a mercy iteration: alive masks equal to the JAX
  trainer's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_redundancy import make_cams, np_min_pixel_size
from test_torch_sh_culling import pool_leaves, to_torch_pool, torch_cams

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.config import OptimizationParams as TOpt
from reduced3dgs_torch.models import gaussians as TG
from reduced3dgs_torch.ops import knn as tknn
from reduced3dgs_torch.ops import redundancy as TR
from reduced3dgs_torch.ops.transforms import quat_to_rotmat as t_rotmat
from reduced3dgs_torch.train import adam as tadam
from reduced3dgs_torch.train import densify as tdensify
from reduced3dgs_torch.train import trainer as ttrainer
from reduced3dgs_tpu.config import OptimizationParams as JOpt
from reduced3dgs_tpu.models import gaussians as JG
from reduced3dgs_tpu.ops import knn as jknn
from reduced3dgs_tpu.ops import redundancy as JR
from reduced3dgs_tpu.train import adam as jadam
from reduced3dgs_tpu.train import densify as jdensify
from reduced3dgs_tpu.train import trainer as jtrainer


def _cam_tensors(cams):
    return (torch.as_tensor(np.stack([c.full_proj_transform for c in cams])),
            torch.as_tensor(np.stack([c.inverse_full_proj_transform
                                      for c in cams])),
            torch.tensor([c.height for c in cams], dtype=torch.int32),
            torch.tensor([c.width for c in cams], dtype=torch.int32))


def _cam_arrays(cams):
    return (jnp.stack([jnp.asarray(c.full_proj_transform) for c in cams]),
            jnp.stack([jnp.asarray(c.inverse_full_proj_transform)
                       for c in cams]),
            jnp.array([c.height for c in cams], jnp.int32),
            jnp.array([c.width for c in cams], jnp.int32))


def test_min_pixel_size_matches_numpy():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    jcams = make_cams()
    cams = torch_cams(jcams)
    for a, b in zip(cams, jcams):  # the port's cameras carry the inverse
        np.testing.assert_allclose(a.inverse_full_proj_transform,
                                   b.inverse_full_proj_transform, rtol=1e-5,
                                   atol=1e-6)
    got = TR.min_projected_pixel_size(torch.as_tensor(xyz),
                                      *_cam_tensors(cams)).numpy()
    np.testing.assert_allclose(got, np_min_pixel_size(xyz, jcams),
                               rtol=1e-3, atol=1e-5)
    want = np.asarray(JR.min_projected_pixel_size(jnp.asarray(xyz),
                                                  *_cam_arrays(jcams)))
    np.testing.assert_allclose(got, want, rtol=2e-3)
    # a portrait image steps in y: the same matrices, sizes swapped
    proj, inv, hts, wds = _cam_tensors(cams)
    jproj, jinv, jh, jw = _cam_arrays(jcams)
    tall = TR.min_projected_pixel_size(torch.as_tensor(xyz), proj, inv, wds,
                                       hts).numpy()
    want = np.asarray(JR.min_projected_pixel_size(jnp.asarray(xyz), jproj,
                                                  jinv, jw, jh))
    np.testing.assert_allclose(tall, want, rtol=2e-3)
    assert not np.allclose(tall, got, rtol=1e-2)


def test_sphere_ellipsoid_matches_numpy():
    rng = np.random.default_rng(1)
    n, k = 40, 8
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    nbrs = np.stack([rng.permutation(n)[:k] for _ in range(n)])
    radius = rng.uniform(0.01, 0.2, n).astype(np.float32)
    counts, mask = TR.sphere_ellipsoid_intersection(
        *(torch.as_tensor(a) for a in (xyz, scales, q, nbrs, radius)))
    rmats = t_rotmat(torch.as_tensor(q)).numpy()
    want = np.zeros((n, k), bool)
    for i in range(n):
        for jj, j in enumerate(nbrs[i]):
            # the reference's quirk: the POINT's own rotation (R[idx])
            local = (xyz[i] - xyz[j]) @ rmats[i]
            want[i, jj] = np.sum((local / (scales[j] + radius[i])) ** 2) < 1
    np.testing.assert_array_equal(mask.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), want.sum(1))
    assert counts.dtype == torch.int32


def test_allocate_min_redundancy():
    vals = torch.tensor([5, 2, 9, 1], dtype=torch.int32)
    nbrs = torch.tensor([[1, 2], [0, 3], [3, 0], [2, 1]])
    mask = torch.tensor([[1, 1], [1, 0], [1, 1], [0, 1]], dtype=torch.bool)
    got = TR.allocate_min_redundancy(vals, nbrs, mask, 4)
    np.testing.assert_array_equal(got.numpy(), [2, 1, 5, 9])
    want = np.asarray(JR.allocate_min_redundancy(
        jnp.asarray(vals.numpy()), jnp.asarray(nbrs.numpy(), jnp.int32),
        jnp.asarray(mask.numpy()), 4))
    np.testing.assert_array_equal(got.numpy(), want)


def _metric_inputs(seed=2, cap=256, n=150):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(0, 0.15, (n // 2, 3)),
                          rng.uniform(-1, 1, (cap - n // 2, 3))]).astype(
        np.float32)
    scales = rng.uniform(0.01, 0.25, (cap, 3)).astype(np.float32)
    q = rng.normal(0, 1, (cap, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n]] = True
    return xyz, scales, q, alive


def _np_knn(pts, k):
    """Brute-force neighbour sets in float64 numpy."""
    d = ((pts[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("n,k", [(128, 30), (64, 8)])
def test_redundancy_metric_matches_jax(n, k):
    """The whole metric, kNN included, on pools whose alive count is a
    power of two (the compacted view then has no absent rows): the
    integer metric equal, the cube size rtol 2e-3 (an unprojection
    through the inverse projection cancels differently in the two
    frameworks; tests/test_redundancy.py holds it to 1e-3 of numpy)."""
    xyz, scales, q, alive = _metric_inputs(n=n)
    jcams = make_cams()
    want_red, want_cube = JR.redundancy_metric(
        *(jnp.asarray(a) for a in (xyz, scales, q, alive)),
        *_cam_arrays(jcams), pixel_scale=1.5, num_neighbours=k)
    red, cube = TR.redundancy_metric(
        *(torch.as_tensor(a) for a in (xyz, scales, q, alive)),
        *_cam_tensors(torch_cams(jcams)), pixel_scale=1.5, num_neighbours=k)
    assert red.dtype == torch.int32 and red.shape == (256,)
    np.testing.assert_array_equal(red.numpy(), np.asarray(want_red))
    np.testing.assert_allclose(cube.numpy(), np.asarray(want_cube),
                               rtol=2e-3)
    assert not red.numpy()[~alive].any() and not cube.numpy()[~alive].any()
    assert red.numpy()[alive].min() >= 1  # every live point counts itself
    assert red.numpy()[alive].max() > 3  # the cluster overlaps


@pytest.mark.parametrize("n,k", [(150, 30), (20, 30)])
def test_redundancy_core_with_absent_rows_matches_jax(n, k):
    """Alive counts that are no power of two: the compacted view is padded
    with +inf absent rows (20 alive < 30 neighbours: absent rows fill the
    lists).  The port's neighbour lists are the true ones (numpy brute
    force over the real rows), and on those lists the JAX package's core
    gives the same integers: absent rows intersect nothing, receive
    nothing and count for nothing."""
    xyz, scales, q, alive = _metric_inputs(n=n)
    jcams = make_cams()
    seen = {}

    def spy(points, kk):
        seen["pts"] = points
        seen["idx"] = tknn.knn_exact(points, kk)[1]
        return seen["idx"]

    red, cube = TR.redundancy_metric(
        *(torch.as_tensor(a) for a in (xyz, scales, q, alive)),
        *_cam_tensors(torch_cams(jcams)), pixel_scale=1.5, num_neighbours=k,
        neighbours_fn=spy)
    pts, idx = seen["pts"].numpy(), seen["idx"].numpy()
    m = pts.shape[0]
    assert m == max(1 << (n - 1).bit_length(), k + 1)
    absent = ~np.isfinite(pts).all(1)
    assert absent.sum() == m - n and not absent[:n].any()
    kk = min(k, n - 1)
    np.testing.assert_array_equal(np.sort(idx[:n, :kk], axis=1),
                                  np.sort(_np_knn(pts[:n], kk), axis=1))
    assert (idx[:n, kk:] >= n).all()  # then absent rows, never the query
    order = np.argsort(~alive, kind="stable")[:m]
    jred, jcube = JR._redundancy_core(
        jnp.asarray(pts), jnp.asarray(scales[order]), jnp.asarray(q[order]),
        jnp.asarray(absent), jnp.asarray(idx, jnp.int32),
        *_cam_arrays(jcams), jnp.float32(1.5))
    np.testing.assert_array_equal(red.numpy()[order][:n],
                                  np.asarray(jred)[:n])
    np.testing.assert_allclose(cube.numpy()[order][:n],
                               np.asarray(jcube)[:n], rtol=2e-3)
    assert not red.numpy()[~alive].any()


def test_knn_exact_absent_rows():
    """+inf rows are absent: never a neighbour while a real other point is
    left, no NaN from inf - inf, and the real neighbours are the true ones
    (numpy brute force; also the JAX package's on an all-real cloud)."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    want = np.asarray(jknn.knn_indices(jnp.asarray(pts), 10))
    _, idx = tknn.knn_exact(torch.as_tensor(pts), 10)
    np.testing.assert_array_equal(np.sort(idx.numpy(), axis=1),
                                  np.sort(want, axis=1))
    pts[40:] = np.inf  # absent rows
    d2, idx = tknn.knn_exact(torch.as_tensor(pts), 10)
    assert not torch.isnan(d2).any()
    assert bool(torch.isfinite(d2[:40]).all())
    np.testing.assert_array_equal(np.sort(idx[:40].numpy(), axis=1),
                                  np.sort(_np_knn(pts[:40], 10), axis=1))
    # more neighbours than real others: the real ones first, then inf
    d2, idx = tknn.knn_exact(torch.as_tensor(pts[:48]), 45)
    assert bool(torch.isfinite(d2[:40, :39]).all())
    assert bool(torch.isinf(d2[:40, 39:]).all())
    assert bool((idx[:40, 39:] >= 40).all())  # never the query itself


def test_masked_quantile_and_median_match_torch():
    rng = np.random.default_rng(3)
    v = rng.normal(0, 1, 97).astype(np.float32)
    mask = rng.uniform(size=97) < 0.7
    tv, tm = torch.as_tensor(v), torch.as_tensor(mask)
    for q in (0.03, 0.045, 0.5, 0.9, 1.0):
        got = float(tdensify.masked_quantile(tv, tm, q))
        want = float(torch.quantile(tv[tm], q))
        assert abs(got - want) < 1e-5, (q, got, want)
        assert abs(got - float(jdensify.masked_quantile(
            jnp.asarray(v), jnp.asarray(mask), q))) < 1e-6
    assert abs(float(tdensify.masked_median(tv, tm))
               - float(torch.median(tv[tm]))) < 1e-6


def test_masked_quantile_boundary_cases():
    v = torch.tensor([5.0, 2.0, 9.0, 7.0])
    one = torch.tensor([False, True, False, False])
    for q in (0.0, 0.37, 0.5, 1.0):
        assert float(tdensify.masked_quantile(v, one, q)) == 2.0
    assert float(tdensify.masked_median(v, one)) == 2.0
    two = torch.tensor([True, False, True, False])
    for q in (0.0, 0.25, 1.0):
        assert abs(float(tdensify.masked_quantile(v, two, q))
                   - float(torch.quantile(v[two], q))) < 1e-6
    assert float(tdensify.masked_median(v, two)) == 5.0  # the lower middle
    every = torch.ones(4, dtype=torch.bool)
    assert float(tdensify.masked_quantile(v, every, 1.0)) == 9.0
    assert float(tdensify.masked_median(v, every)) == 5.0


def _mercy_pool(seed=9):
    rng = np.random.default_rng(seed)
    jpool = JG.create_from_pcd(
        rng.normal(0, 1, (64, 3)).astype(np.float32),
        rng.uniform(0, 1, (64, 3)).astype(np.float32), capacity=128)
    return jpool._replace(params=jpool.params._replace(
        opacity=jnp.asarray(rng.normal(0, 1, (128, 1)).astype(np.float32))))


@pytest.mark.parametrize("mercy_type", tdensify.MERCY_TYPES)
def test_mercy_points_matches_jax(mercy_type):
    jpool = _mercy_pool()
    rng = np.random.default_rng(4)
    counts = np.where(np.arange(128) < 20, 50, 1) + rng.integers(0, 3, 128)
    key = jax.random.PRNGKey(1)
    jp, _, jstats = jdensify.mercy_points(
        jpool, jadam.init(jpool.params), key, jnp.asarray(counts),
        lambda_mercy=1.0, mercy_minimum=2, mercy_type=mercy_type)
    uniform = np.asarray(jax.random.uniform(key, (128,)))
    tpool = to_torch_pool(jpool)
    tp, _, tstats = tdensify.mercy_points(
        tpool, tadam.init(tpool.params), torch.as_tensor(counts),
        lambda_mercy=1.0, mercy_minimum=2, mercy_type=mercy_type,
        uniform=torch.as_tensor(uniform))
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(jp.alive))
    assert int(tstats["n_points_mercied"]) \
        == int(jstats["n_points_mercied"]) > 0
    for k in ("redundancy_threshold", "opacity_threshold"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5)
    if mercy_type == "redundancy_opacity":
        # strictly below the lower median of the 20 hot points: 9 of 20
        assert int(tstats["n_points_mercied"]) == 9
    with pytest.raises(ValueError):
        tdensify.mercy_points(tpool, tadam.init(tpool.params),
                              torch.as_tensor(counts), mercy_type="nope")


def test_mercy_random_draws_from_the_generator():
    tpool = to_torch_pool(_mercy_pool())
    counts = torch.where(torch.arange(128) < 20, 50, 1)
    outs = []
    for seed in (0, 0, 1):
        gen = torch.Generator().manual_seed(seed)
        st = ttrainer.TrainState(tpool, tadam.init(tpool.params), gen)
        st, stats = ttrainer.mercy_step(
            st, counts, lambda_mercy=1.0, mercy_minimum=2,
            mercy_type="redundancy_random")
        assert 0 < int(stats["n_points_mercied"]) < 20
        outs.append(st.pool.alive)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])


class _JScene:
    """The part of the JAX Scene the trainer's mercy block uses."""

    def __init__(self, cams):
        self.cams, self.pool = cams, None

    def calculate_redundancy_metric(self, pixel_scale=1.0):
        p = self.pool
        return JR.redundancy_metric(
            p.params.xyz, p.get_scaling(), p.get_rotation(), p.alive,
            *_cam_arrays(self.cams), pixel_scale=pixel_scale)


def test_trainer_schedule_with_mercy_matches_jax():
    """Iterations 1-3 with a mercy pass at 2 (mercy_interval 1 x
    densification_interval 2, inside the fine-tune limit): the step
    before it applies no update (mercy prunes without store_grads), the
    alive masks agree with the JAX trainer, and training goes on."""
    from test_sh_culling import make_pool_and_cams

    jpool, jcams = make_pool_and_cams(n=32)
    rng = np.random.default_rng(8)
    leaves = pool_leaves(jpool)
    leaves["xyz"][:16] = rng.normal(0, 0.03, (16, 3))  # an overlapping knot
    leaves["scaling"][:] = np.log(0.08)
    leaves["opacity"][:] = rng.normal(0, 1, leaves["opacity"].shape)
    jpool = jpool._replace(params=JG.GaussianParams(
        **{k: jnp.asarray(leaves[k]) for k in JG.GaussianParams._fields}))
    for c in jcams:
        c.image = rng.uniform(0, 1, (c.height, c.width, 3)).astype(
            np.float32)
    tcams = torch_cams(jcams)
    kw = dict(iterations=3010, densify_from_iter=5000,
              densification_interval=2, mercy_interval=1, mercy_points=True,
              lambda_mercy=0.5, mercy_minimum=2, box_size=2.0)
    jtr = jtrainer.Trainer(
        jpool, dataclasses.replace(JOpt(), **kw), jcams,
        spatial_lr_scale=3.0, background=np.zeros(3, np.float32),
        backend="pallas", initial_budget=4096, seed=1,
        scene=_JScene(jcams))
    ttr = ttrainer.Trainer(
        TG.pool_from_numpy(leaves, "cpu"),
        dataclasses.replace(TOpt(), **kw), tcams, spatial_lr_scale=3.0,
        background=torch.zeros(3), backend="tile", initial_budget=4096,
        seed=1)
    jtr.extent = ttr.extent = 3.0
    assert ttr.fine_tune_start == jtr.fine_tune_start == 10
    assert [ttr._events(i)[3] for i in (1, 2, 3, 4, 12)] \
        == [jtr._events(i)[3] for i in (1, 2, 3, 4, 12)] \
        == [False, True, False, True, False]
    for it in (1, 2, 3):
        jtr.step(it)
        ttr.step(it)
        np.testing.assert_array_equal(ttr.state.pool.alive.numpy(),
                                      np.asarray(jtr.state.pool.alive))
    assert ttr.stats["n_points_mercied"] \
        == jtr.stats["n_points_mercied"] > 0
    np.testing.assert_allclose(ttr.stats["redundancy_threshold"],
                               jtr.stats["redundancy_threshold"], rtol=1e-5)
    # iteration 2 took no optimizer step; 1 and 3 did
    assert list(ttr.state.opt.step) == [2] * 6
    assert [int(s) for s in jtr.state.opt.step] == [2] * 6
