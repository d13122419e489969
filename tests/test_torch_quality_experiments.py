"""The cores of the port's three quality experiments against the JAX
computations on the CPU, at 32x32 with a few hundred primitives.

* half_float_ablation: the eight rows (f32_all, f16_<group> for each of
  the six groups, f16_all) of one pool, rounded through float16 as the
  JAX script rounds (its own f16), scored by the JAX render ("pallas",
  interpret mode) and psnr: within 1e-3 dB of the port's rows;
* prune_finetune: the pruned mask equal to the JAX script's selection
  from the same opacities; the pack file (quantised + half floats + the
  u16c xyz codec) reloads to the arrays the JAX loader reads from it and
  to those of the file the JAX package writes from the same pool and
  codebooks;
* grad_reduce_ab part 1: the relative L2 of the bf16x2 against the f32
  gradient of each leaf within 1e-3 (absolute) of the JAX package's
  ("pallas" in interpret mode, grad_reduce bf16x2 / f32), the world and
  cameras the JAX script's.

Two findings of the evaluation gap's search, in both packages: a stored
model keeps its SH degrees through a degree step (the port's repair),
and small per-primitive gradients follow the XLA oracle in the port
where the JAX package's Pallas reduction drops some signs (the
reference's fault, not repeated).  tests/test_torch_port_rules.py checks
that the three entry points import no JAX and raise without a card
unless --device cpu is given.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_compression import make_pool
from test_torch_sh_culling import to_torch_pool

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch import compress as tcompress
from reduced3dgs_torch import grad_reduce_ab as tgr
from reduced3dgs_torch import half_float_ablation as thf
from reduced3dgs_torch import prune_finetune as tpf
from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.models import ply_io as tply
from reduced3dgs_torch.ops import kmeans as tkm
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.models import gaussians as JG
from reduced3dgs_tpu.models import ply_io as jply
from reduced3dgs_tpu.ops import kmeans as jkm
from reduced3dgs_tpu.ops.losses import psnr as jpsnr
from reduced3dgs_tpu.renderer import render as jrender

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
BUDGET = 1 << 13  # the JAX renders' (no view overflows it)
EYES = ((0.0, 0.4, -4.0), (2.8, -0.3, -2.8))


def _jax_script(name):
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _jrender(pool, cam, budget=BUDGET, **kw):
    return jrender(pool.params.xyz, pool.features(), pool.params.scaling,
                   pool.params.rotation, pool.params.opacity[:, 0],
                   pool.degrees, cam.params(), jnp.zeros(3), width=SIZE,
                   height=SIZE, instance_budget=budget,
                   alive_mask=pool.alive, backend="pallas", **kw)


def _views():
    """Two 32x32 views of another pool as ground truth: the JAX cameras
    and the port's at the same poses with the same images."""
    world = make_pool(n=300, cap=512, seed=7)
    jcams, tcams = [], []
    for i, eye in enumerate(EYES):
        cam = JCamera.look_at(eye=eye, target=(0, 0, 0), width=SIZE,
                              height=SIZE, uid=i)
        cam.image = np.clip(np.asarray(_jrender(world, cam).color), 0, 1)
        jcams.append(cam)
        tcams.append(TCamera.look_at(eye=eye, target=(0, 0, 0), width=SIZE,
                                     height=SIZE, uid=i, image=cam.image))
    return jcams, tcams


def _jax_mean_psnr(pool, cams):
    ps = []
    for cam in cams:
        out = _jrender(pool, cam)
        assert int(out.num_rendered) <= BUDGET
        ps.append(float(jpsnr(jnp.clip(out.color, 0, 1),
                              jnp.asarray(cam.image))))
    return float(np.mean(ps))


def test_half_float_rows_match_jax(capsys):
    jcams, tcams = _views()
    jpool = make_pool(n=300, cap=512, seed=1)
    tpool = to_torch_pool(jpool)
    got = thf.ablation_rows(tpool, tcams, torch.device("cpu"))
    printed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in printed] == list(got)

    f16 = _jax_script("half_float_ablation").f16
    base = {g: np.asarray(getattr(jpool.params, g)) for g in thf.GROUPS}

    def score(arrs):
        params = jpool.params._replace(
            **{k: jnp.asarray(v) for k, v in arrs.items()})
        return _jax_mean_psnr(jpool._replace(params=params), jcams)

    want = {"f32_all": score(base)}
    for g in thf.GROUPS:
        want[f"f16_{g}"] = score(dict(base, **{g: f16(base[g])}))
    want["f16_all"] = score({g: f16(v) for g, v in base.items()})
    assert list(got) == list(want) and len(got) == 8
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    # the rounding is the JAX script's, bit for bit
    for g in thf.GROUPS:
        np.testing.assert_array_equal(
            thf.f16(getattr(tpool.params, g)).numpy(), f16(base[g]))
    # the rows say something: the f32 score is finite and the pool is seen
    assert np.isfinite(want["f32_all"]) and want["f32_all"] > 5.0
    ranges = thf.ranges(tpool)
    assert ranges["xyz"]["absmax"] == float(np.abs(base["xyz"]).max())


def _jax_script_mask(jpool, frac):
    """experiments/prune_finetune.py's selection, line for line."""
    alive = np.asarray(jpool.alive)
    op = 1 / (1 + np.exp(-np.asarray(jpool.params.opacity[:, 0])))
    n0 = int(alive.sum())
    k = int(n0 * frac)
    score = np.where(alive, op, np.inf)
    cut = np.argsort(score)[:k]
    m = alive.copy()
    m[cut] = False
    return m


def _holed_pool(seed):
    """make_pool with a few dead rows among the alive ones."""
    jpool = make_pool(n=300, cap=512, seed=seed)
    alive = np.asarray(jpool.alive).copy()
    alive[np.random.default_rng(seed).choice(300, 40, replace=False)] = False
    return jpool._replace(alive=jnp.asarray(alive))


@pytest.mark.parametrize("frac", [0.10, 0.15, 0.17])
def test_pruned_mask_is_the_jax_scripts(frac):
    jpool = _holed_pool(2)
    got = tcompress.prune_pool(to_torch_pool(jpool), frac)[0].alive.numpy()
    want = _jax_script_mask(jpool, frac)
    np.testing.assert_array_equal(got, want)
    assert int(want.sum()) == 260 - int(260 * frac)


def test_pack_file_reloads_to_the_saved_arrays(tmp_path):
    jpool = _holed_pool(3)
    tpool = tcompress.prune_pool(to_torch_pool(jpool), 0.15)[0]
    jpool = jpool._replace(alive=jnp.asarray(tpool.alive.numpy()))
    path = str(tmp_path / "pf_15.ply")
    rpool, _ = tpf.store_pack(tpool, path)
    got = tply.load_gaussian_ply(path, quantised=True, half_float=True)
    want = jply.load_gaussian_ply(path, quantised=True, half_float=True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the reloaded pool is what the JAX package builds from the file
    jr = jply.pool_from_arrays(want)
    for name, leaf in rpool.params._asdict().items():
        np.testing.assert_array_equal(
            leaf.numpy(), np.asarray(getattr(jr.params, name)), err_msg=name)
    np.testing.assert_array_equal(rpool.alive.numpy(), np.asarray(jr.alive))
    assert int(rpool.alive.sum()) == int(tpool.alive.sum())
    # the JAX package writes the same arrays from the same pool and books
    books = {k: jkm.Codebook(jnp.asarray(v.ids.numpy()),
                             jnp.asarray(v.centers.numpy()))
             for k, v in tkm.produce_clusters(tpool).items()}
    jpath = str(tmp_path / "jax.ply")
    jply.save_gaussian_ply(jpath, jpool, books, quantised=True,
                           half_float=True, xyz_codec="u16c")
    assert os.path.getsize(jpath) == os.path.getsize(path)
    again = jply.load_gaussian_ply(jpath, quantised=True, half_float=True)
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


def test_grad_reduce_part1_matches_jax(monkeypatch):
    """Part 1 on the JAX script's world and cameras at 32x32: a
    300-point pool from its draws, the gradients of both packages in
    both modes."""
    monkeypatch.setattr(tgr, "SIZE", SIZE)
    monkeypatch.setattr(tgr, "BUDGET", BUDGET)
    monkeypatch.setattr(tgr, "N_GT", 400)
    rng = np.random.default_rng(7)
    world = tgr.make_world(rng)
    tcams = tgr.make_cameras()
    tgr.render_ground_truth(world, tcams, torch.device("cpu"))
    cam = tcams[1]  # the JAX script's train_cams[0]
    pts = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (300, 3)).astype(np.float32)
    jpool = JG.create_from_pcd(pts, cols, capacity=512)
    got = tgr.grad_rel_l2(to_torch_pool(jpool), cam, torch.device("cpu"))

    a = np.linspace(0, 2 * np.pi, 14, endpoint=False)[1]
    jcam = JCamera.look_at(eye=(np.cos(a) * 3.2, 0.9, np.sin(a) * 3.2),
                           target=(0, 0, 0), width=SIZE, height=SIZE, uid=1)
    np.testing.assert_allclose(jcam.full_proj_transform,
                               cam.full_proj_transform, atol=1e-6)
    gt = jnp.asarray(cam.image)

    def loss_fn(params, mode):
        feats = jnp.concatenate([params.features_dc, params.features_rest],
                                axis=1)
        out = jrender(params.xyz, feats, params.scaling, params.rotation,
                      params.opacity[:, 0], jpool.degrees, jcam.params(),
                      jnp.zeros(3), width=SIZE, height=SIZE,
                      instance_budget=BUDGET, alive_mask=jpool.alive,
                      backend="pallas", grad_reduce=mode)
        return jnp.abs(out.color - gt).mean()

    g = {m: jax.grad(lambda p, m=m: loss_fn(p, m))(jpool.params)
         for m in ("f32", "bf16x2")}
    want = {}
    for k in tgr.PARAMS:
        a = np.asarray(getattr(g["f32"], k)).ravel()
        b = np.asarray(getattr(g["bf16x2"], k)).ravel()
        denom = float(np.linalg.norm(a))
        want[k] = float(np.linalg.norm(b - a) / denom) if denom else 0.0
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert max(want.values()) > 1e-4  # the rounding shows in some leaf
    assert got["features_rest"] == want["features_rest"] == 0.0


def test_loaded_model_keeps_its_degrees_through_a_degree_step(tmp_path):
    """A stored model loads at the top SH degree in both packages, so a
    fine-tune step at a multiple of 1000 (compress.py's and
    prune_finetune's run from 10,000 on) leaves every primitive's degree
    where the file put it, as the JAX Trainer does.  (The port loaded it
    at degree 0, and such a step raised every alive degree by one.)"""
    from test_training import target_scene
    from test_torch_sh_culling import torch_cams

    from reduced3dgs_torch.config import OptimizationParams as TOpt
    from reduced3dgs_torch.train.trainer import Trainer as TTrainer
    from reduced3dgs_tpu.config import OptimizationParams as JOpt
    from reduced3dgs_tpu.train.trainer import Trainer as JTrainer

    jcams = target_scene()
    path = str(tmp_path / "point_cloud.ply")
    tply.save_gaussian_ply(path, to_torch_pool(make_pool(n=60, cap=64)))
    arrs = tply.load_gaussian_ply(path)
    tpool = tply.pool_from_arrays(arrs, "cpu")
    jpool = jply.pool_from_arrays(jply.load_gaussian_ply(path))
    assert tpool.active_sh_degree == int(jpool.active_sh_degree) == 3
    cfg = dict(iterations=1200, densify_until_iter=0,
               opacity_reset_interval=10 ** 9)
    jtr = JTrainer(jpool, JOpt(**cfg), jcams, spatial_lr_scale=3.0,
                   background=jnp.zeros(3), backend="xla",
                   initial_budget=4096)
    ttr = TTrainer(tpool, TOpt(**cfg), torch_cams(jcams),
                   spatial_lr_scale=3.0, background=torch.zeros(3),
                   backend="ref", initial_budget=4096)
    jtr.extent = ttr.extent = 3.0
    jtr.step(1000)
    ttr.step(1000)
    got = ttr.state.pool.degrees.numpy()
    np.testing.assert_array_equal(got, np.asarray(jtr.state.pool.degrees))
    np.testing.assert_array_equal(got[:60], arrs["degrees"])
    assert ttr.state.pool.active_sh_degree == 3


def test_small_gradients_follow_the_oracle():
    """A fault of the reference, not repeated (ROADMAP queue 3): the JAX
    package's Pallas reduction forms a primitive's gradient as a
    difference of prefix sums over every instance slot, so a gradient
    far below the running prefix loses its digits, its sign or all of it
    (f32 mode here; the TPU's default path rounds to bf16 first).  The
    port sums each primitive's slots directly: on 4,000 points in
    tests/test_training.py's 48x48 view, the opacity gradients of the
    rows below 1e-7 follow the JAX XLA oracle (median relative error
    below 1e-3, no sign lost) where the Pallas path flips or zeroes some.
    Adam's first step turns each such sign into a full learning-rate
    step: the first divergence of the two packages' trainings."""
    from test_training import target_scene
    from test_torch_sh_culling import torch_cams

    from reduced3dgs_torch.renderer import render as trender

    jcam = target_scene()[0]
    tcam = torch_cams([jcam])[0]
    rng = np.random.default_rng(3)
    jpool = JG.create_from_pcd(
        rng.uniform(-0.9, 0.9, (4000, 3)).astype(np.float32),
        rng.uniform(0.2, 0.8, (4000, 3)).astype(np.float32), capacity=4096)
    tpool = to_torch_pool(jpool)
    gt = jnp.asarray(jcam.image)

    def jgrad(backend):
        def loss(op):
            out = jrender(jpool.params.xyz, jpool.features(),
                          jpool.params.scaling, jpool.params.rotation, op,
                          jpool.degrees, jcam.params(), jnp.zeros(3),
                          width=48, height=48, instance_budget=1 << 16,
                          alive_mask=jpool.alive, backend=backend)
            return jnp.abs(out.color - gt).mean()
        return np.asarray(jax.grad(loss)(jpool.params.opacity[:, 0]))

    oracle, pallas = jgrad("xla"), jgrad("pallas")
    op = tpool.params.opacity[:, 0].clone().requires_grad_()
    out = trender(tpool.params.xyz, tpool.features(), tpool.params.scaling,
                  tpool.params.rotation, op, tpool.degrees,
                  tcam.params("cpu"), torch.zeros(3), width=48, height=48,
                  instance_budget=1 << 16, alive_mask=tpool.alive)
    port = torch.autograd.grad(
        (out.color - torch.as_tensor(jcam.image)).abs().mean(), op)[0]
    port = port.numpy()
    small = (np.asarray(jpool.alive) & (oracle != 0)
             & (np.abs(oracle) <= 1e-7))
    assert small.sum() > 100
    rel = np.abs(port[small] - oracle[small]) / np.abs(oracle[small])
    assert np.median(rel) < 1e-3
    assert (np.sign(port[small]) == np.sign(oracle[small])).all()
    lost = np.sign(pallas[small]) != np.sign(oracle[small])
    assert lost.any()  # the reference's prefix sums drop some signs
