"""The port's multi-device path (reduced3dgs_torch/parallel) against the
JAX package's (reduced3dgs_tpu/parallel, tests/test_sharded.py).

The port's ranks are processes of one gloo group on the CPU, started by
``launch.spawn_local`` (OMP_NUM_THREADS=1 each); they run
tests/torch_parallel_child.py, which imports no jax.  The cases of one
mesh shape run in one spawn group (a module fixture); the JAX steps run
on the conftest's 8-device virtual mesh in this process, from the same
pool leaves and ground-truth images.

Tolerances:
* against the JAX sharded step: the loss rtol 1e-5; raw gradients leaf by
  leaf at the render tolerance of tests/test_torch_train.py (atol 2e-4
  max|g|, rtol 2e-3); densification counts exactly;
* against the port's own single-card step (the JAX tests' comparison):
  tests/test_sharded.py's tolerances, raw gradients at atol 2e-6 + 1e-4
  max|g| (an inflation by the mesh size or a regularizer counted twice
  fails), parameters atol 5e-6 / rtol 1e-4;
* step groups (ShardedTrainer.step_group) against sequential
  ShardedTrainer.step calls bit for bit, and against the JAX package's
  ShardedTrainer.step_group (run once, on the (2, 2) mesh) at the
  tolerances above.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_child as child
from test_training import BUDGET, H, W, target_scene

from reduced3dgs_torch.config import OptimizationParams as TOpt
from reduced3dgs_torch.parallel import launch
from reduced3dgs_torch.parallel import sharded as tsh
from reduced3dgs_torch.train import trainer as ttrainer
from reduced3dgs_tpu.config import OptimizationParams as JOpt
from reduced3dgs_tpu.models import gaussians as JG
from reduced3dgs_tpu.parallel import sharded as jsh
from reduced3dgs_tpu.train import adam as jadam
from reduced3dgs_tpu.train.trainer import TrainState as JState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EYES = [(0, 0, -3), (2.1, 0, -2.1), (-2.1, 0.3, -2.1), (0, 2.1, -2.1)]
LEAVES = child.LEAVES
# the surgery run of tests/test_sharded.py::test_sharded_trainer_surgery_parity
SURGERY = dict(densify_from_iter=1, densification_interval=4,
               densify_until_iter=14, opacity_reset_interval=8,
               mercy_points=True, mercy_interval=3, iterations=5000,
               densify_grad_threshold=1e-5)
SURGERY_ITERS = 14


def jax_state(seed=3, cap=256):
    rng = np.random.default_rng(seed)
    pool = JG.create_from_pcd(
        rng.uniform(-0.9, 0.9, (40, 3)).astype(np.float32),
        rng.uniform(0.2, 0.8, (40, 3)).astype(np.float32), capacity=cap)
    return JState(pool, jadam.init(pool.params), jax.random.PRNGKey(0))


def leaves_of(pool):
    out = {k: np.asarray(getattr(pool.params, k)) for k in LEAVES}
    out.update(degrees=np.asarray(pool.degrees),
               alive=np.asarray(pool.alive))
    return out


@pytest.fixture(scope="module")
def setup():
    cams = target_scene(seed=7)
    scene = dict(eyes=EYES, images=[np.asarray(c.image) for c in cams],
                 w=W, h=H, budget=BUDGET)
    state = jax_state()
    return cams, scene, state, leaves_of(state.pool)


def spawn(fn, world, *args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return launch.spawn_local(fn, world, "gloo", "cpu", *args)


@pytest.fixture(scope="module")
def ranks_1x4(setup):
    _, scene, _, leaves = setup
    res = spawn(child.one_by_four, 4, scene, leaves)
    trainer = spawn(child.trainer_run, 4, scene, _surgery_leaves(), SURGERY,
                    SURGERY_ITERS)
    return res, trainer


@pytest.fixture(scope="module")
def ranks_2x2(setup):
    _, scene, _, leaves = setup
    return spawn(child.two_by_two, 4, scene, leaves)


@pytest.fixture(scope="module")
def ranks_1x2(setup):
    _, scene, _, leaves = setup
    return spawn(child.one_by_two, 2, scene, leaves)


def _jax_step(setup, mesh_shape, n_cams=1, cfg=None, **kw):
    cams, _, state, _ = setup
    cfg = cfg or JOpt()
    mesh = jsh.make_mesh(*mesh_shape)
    st_in = (jsh.shard_state(state, mesh, param_shard=True)
             if kw.get("param_shard") else state)
    gts = jnp.stack([jnp.asarray(c.image) for c in cams[:n_cams]])
    return jsh.sharded_train_step(
        st_in, jsh.stack_camera_params(cams[:n_cams]), gts, jnp.zeros(3),
        jnp.int32(1), mesh=mesh, width=W, height=H,
        budget=kw.pop("budget", BUDGET), opt_cfg=cfg, spatial_lr_scale=3.0,
        **kw)


def _port_single(setup, cfg, skip_update=False):
    cams, _, _, leaves = setup
    st = child.state_from(leaves, "cpu")
    return ttrainer.train_step(
        st, _tcam(cams[0]), torch.as_tensor(np.asarray(cams[0].image)),
        torch.zeros(3), 1, width=W, height=H, budget=BUDGET, backend="tile",
        opt_cfg=cfg, spatial_lr_scale=3.0, skip_update=skip_update)


def _tcam(jcam):
    from reduced3dgs_torch.cameras import Camera

    return Camera.look_at(eye=EYES[jcam.uid], target=(0, 0, 0), width=W,
                          height=H, uid=jcam.uid).params("cpu")


def _surgery_leaves():
    rng = np.random.default_rng(5)
    pool = JG.create_from_pcd(
        rng.uniform(-0.9, 0.9, (40, 3)).astype(np.float32),
        rng.uniform(0.2, 0.8, (40, 3)).astype(np.float32), capacity=256)
    return leaves_of(pool)


def _render_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-4 * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _params_close(got, single, names, what):
    for k in names:
        np.testing.assert_allclose(got[f"param_{k}"],
                                   getattr(single.pool.params, k).numpy(),
                                   atol=5e-6, rtol=1e-4,
                                   err_msg=f"{what}: param {k}")
    np.testing.assert_allclose(got["xyz_grad_accum"],
                               single.pool.xyz_grad_accum.numpy(),
                               atol=1e-5, rtol=1e-3)


def test_sharded_matches_single_chip(setup, ranks_1x4):
    """Mesh (1, 4), replicated: the port's step against the JAX package's
    sharded step and against the port's single-card step."""
    res = ranks_1x4[0]
    _, m_j = _jax_step(setup, (1, 4))
    st_1, m_1 = _port_single(setup, TOpt())
    for r in res:
        got = r["replicated"]
        np.testing.assert_allclose(got["loss"], float(m_j["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(m_1["loss"]),
                                   rtol=1e-5)
        _params_close(got, st_1, ("xyz", "scaling", "opacity",
                                  "features_dc"), "replicated")
        # every rank holds the same replicated state
        np.testing.assert_array_equal(got["param_xyz"],
                                      res[0]["replicated"]["param_xyz"])


def test_raw_gradients_pinned_both_layouts(setup, ranks_1x4):
    """skip_update gradients of both layouts, leaf by leaf: against the
    port's single-card step at the JAX test's tolerance, and against the
    JAX package's sharded step of the same layout."""
    res = ranks_1x4[0]
    _, _, g_1 = _port_single(setup, TOpt(**child.REG), skip_update=True)
    for param_shard in (False, True):
        _, _, g_j = _jax_step(setup, (1, 4), cfg=JOpt(**child.REG),
                              param_shard=param_shard, skip_update=True)
        for name in LEAVES:
            a = getattr(g_1, name).numpy()
            scale = max(np.abs(a).max(), 1e-12)
            for r in res:
                b = r[f"grads_{param_shard}"][name]
                np.testing.assert_allclose(
                    b, a, atol=2e-6 + 1e-4 * scale, rtol=0,
                    err_msg=f"grad {name}, param_shard={param_shard}")
                _render_close(b, getattr(g_j, name),
                              f"grad {name} vs JAX, {param_shard}")
        # the pool starts with features_rest = 0, where JAX differentiates
        # the sparsity term's |x| as +1 (and so does the port's abs_jax):
        # the gradient is exactly lambda_sh_sparsity / (45 nvis) on every
        # visible row, in both packages
        g = np.asarray(g_j.features_rest)
        vis = np.abs(g).reshape(g.shape[0], -1).max(1) > 0
        assert vis.sum() > 10
        want = child.REG["lambda_sh_sparsity"] / (45 * vis.sum())
        np.testing.assert_allclose(g[vis], want, rtol=1e-5)
        for r in res:
            b = r[f"grads_{param_shard}"]["features_rest"]
            np.testing.assert_allclose(b[vis], want, rtol=1e-5)
            assert not b[~vis].any()


def test_param_sharded_matches_single_chip(setup, ranks_1x4):
    """param_shard: each rank holds cap / 4 rows of every capacity leaf
    (parameters and Adam moments), and the step matches the port's
    single-card step and the JAX package's sharded one."""
    res = ranks_1x4[0]
    cfg = child.REG
    st_j, m_j = _jax_step(setup, (1, 4), cfg=JOpt(**cfg), param_shard=True)
    st_1, m_1 = _port_single(setup, TOpt(**cfg))
    for rank, r in enumerate(res):
        got = r["sharded"]
        np.testing.assert_allclose(got["loss"], float(m_j["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(m_1["loss"]),
                                   rtol=1e-5)
        _params_close(got, st_1, LEAVES, "param_shard")
        np.testing.assert_array_equal(got["denom"],
                                      np.asarray(st_j.pool.denom))
        np.testing.assert_array_equal(got["denom"], st_1.pool.denom.numpy())
        held = r["rows_held"]
        assert {held[k] for k in ("param", "mu", "nu", "alive",
                                  "denom")} == {64}, held
        np.testing.assert_array_equal(
            held["rows"], got["param_xyz"][rank * 64:(rank + 1) * 64])


def test_sharded_data_parallel_batch(setup, ranks_2x2):
    """Mesh (2, 2): two cameras per step; the densification counts sum
    over the camera batch."""
    cams, _, state, _ = setup
    st_j, m_j = _jax_step(setup, (2, 2), n_cams=2)
    x0 = np.asarray(state.pool.params.xyz)
    for r in ranks_2x2:
        got = r["batch"]
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], float(m_j["loss"]),
                                   rtol=1e-5)
        assert np.abs(got["param_xyz"] - x0).max() > 0
        assert got["denom"].max() == 2.0
        np.testing.assert_array_equal(got["denom"],
                                      np.asarray(st_j.pool.denom))
        np.testing.assert_allclose(got["xyz_grad_accum"],
                                   np.asarray(st_j.pool.xyz_grad_accum),
                                   rtol=2e-3, atol=2e-4 * float(np.abs(
                                       st_j.pool.xyz_grad_accum).max()))


def test_sharded_overflow_contract(setup, ranks_1x2):
    """Mesh (1, 2): a budget of 128 reports the true largest strip demand
    (the JAX package's number) with a finite loss; the regrow wrapper
    grows past it and equals a run at the grown budget."""
    _, m_j = _jax_step(setup, (1, 2), budget=128)
    for r in ranks_1x2:
        assert r["needed"] > 128
        assert r["needed"] == int(m_j["num_rendered_max"])
        assert np.isfinite(r["small_loss"])
        assert r["budget"] >= r["needed"]
        np.testing.assert_allclose(r["grown"]["loss"], r["big"]["loss"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(r["grown"]["param_xyz"],
                                      r["big"]["param_xyz"])


def test_sharded_trainer_surgery_parity(ranks_1x4, setup):
    """ShardedTrainer on (1, 4) with param_shard across densify, opacity
    reset and mercy events against the port's single-card Trainer from the
    same pool and seed (tests/test_sharded.py's run and tolerances)."""
    _, scene, _, _ = setup
    ref = child.trainer_run(0, 1, torch.device("cpu"), scene,
                            _surgery_leaves(), SURGERY, SURGERY_ITERS,
                            sharded=False)
    events = set()
    for it in range(1, SURGERY_ITERS + 1):
        d, r, _, m = ttrainer.Trainer._events(_EventProbe(), it)
        events |= {n for n, e in (("densify", d), ("reset", r),
                                  ("mercy", m)) if e}
    assert events == {"densify", "reset", "mercy"}
    assert ref["stats"]["n_points_split"] > 0
    assert ref["stats"]["n_points_mercied"] > 0
    for r in ranks_1x4[1]:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=2e-4)
        np.testing.assert_array_equal(r["alive"], ref["alive"])
        assert r["stats"] == ref["stats"] and r["budgets"] == ref["budgets"]
        assert r["rows_held"] * 4 == ref["rows_held"]
        alive = ref["alive"]
        for name in ("xyz", "scaling", "opacity", "features_dc"):
            np.testing.assert_allclose(
                r["params"][name][alive], ref["params"][name][alive],
                atol=2e-4, rtol=1e-3, err_msg=f"param mismatch: {name}")


class _EventProbe:
    """What Trainer._events reads, for the surgery run's configuration."""

    opt_cfg = TOpt(**SURGERY)
    white_background = False
    scene = object()
    fine_tune_start = SURGERY["iterations"] - 3000


def test_scaling_bench_runs(ranks_2x2):
    """The harness on (1, 1) and (2, 2) ranks, and at world size 1 with
    no process group."""
    for r in ranks_2x2:
        assert [s for s, _ in r["scaling"]] == [(1, 1), (2, 2)]
        assert all(pps > 0 for _, pps in r["scaling"])
    assert len(ranks_2x2[0]["scaling_lines"]) == 2
    assert not ranks_2x2[1]["scaling_lines"]  # rank 0 prints
    lines = []
    res = launch.scaling_bench(widths=(64,), n_prims=256, budget=4096,
                               iters=2, device="cpu", printer=lines.append)
    assert [s for s, _ in res] == [(1, 1)] and res[0][1] > 0
    assert '"mesh": "1x1"' in lines[0]


def test_scaling_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """A measurement never falls back to the CPU: without a card the
    default device raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.scaling_bench(widths=(64,), n_prims=256, iters=1)


def _jax_group(mesh_shape, cfg=None):
    """The JAX package's ShardedTrainer.step_group of child.GROUP
    iterations (param_shard) on the conftest's virtual mesh, from the
    pool, cameras and seed of the port's group_cases."""
    cams = target_scene(seed=7)
    tr = jsh.ShardedTrainer(
        jax_state().pool, cfg or JOpt(), cams,
        mesh=jsh.make_mesh(*mesh_shape), param_shard=True,
        spatial_lr_scale=3.0, background=np.zeros(3), backend="pallas",
        seed=0, initial_budget=BUDGET)
    tr.extent = 3.0
    ms = tr.step_group(range(1, child.GROUP + 1))
    return tr, ms


def _same_runs(a, b, what):
    assert a["metrics"] == b["metrics"], what
    for x, y in zip(a["leaves"], b["leaves"]):
        np.testing.assert_array_equal(x, y, err_msg=what)
    assert a["steps"] == b["steps"] == [child.GROUP] * 6, what
    assert a["next_draw"] == b["next_draw"], what


def test_sharded_step_group_equals_sequential_steps(ranks_1x4):
    """Mesh (1, 4), both layouts: ShardedTrainer.step_group over fusible
    iterations gives ShardedTrainer.step's metrics and every leaf of the
    state bit for bit (the CPU runs the captured step's code in a loop);
    with random backgrounds and a budget every view overflows, the group
    re-runs on the grown budgets and still equals the sequential steps,
    whose random draws it takes in the same order."""
    for r in ranks_1x4[0]:
        for shard, (seq, grp) in r["groups"].items():
            _same_runs(seq, grp, f"param_shard={shard}")
            assert sorted(grp["metrics"][0]) == [
                "l1", "loss", "num_alive", "num_rendered_max"]
            assert seq["budgets"] == grp["budgets"]
        seq, grp = r["overflow"]
        _same_runs(seq, grp, "overflow, random backgrounds")
        assert min(grp["budgets"].values()) > child.OVERFLOW_BUDGET
        assert max(m["num_rendered_max"] for m in grp["metrics"]) \
            > child.OVERFLOW_BUDGET


def test_sharded_step_group_matches_jax(setup, ranks_1x4, ranks_2x2):
    """The port's step_group against the JAX package's ShardedTrainer
    .step_group, which inherits Trainer.step_group: one camera per
    iteration, the single-chip step, whatever the mesh.  The JAX method
    runs once, on the virtual (2, 2) mesh (its data axis is where a
    camera could be counted more than once); the port's runs on (1, 4),
    both layouts, and on (2, 2), where every data group runs the camera
    on its own tile group (no sums over the data axis), match it: loss
    rtol 1e-5, parameters atol 5e-6 / rtol 1e-4, densification counts
    exactly."""
    jtr, jms = _jax_group((2, 2))
    for shape, runs in (((1, 4), [g for r in ranks_1x4[0]
                                  for g in (r["groups"][False][1],
                                            r["groups"][True][1])]),
                        ((2, 2), [r["groups"][0] for r in ranks_2x2])):
        for got in runs:
            for a, b in zip(got["metrics"], jms):
                np.testing.assert_allclose(a["loss"], float(b["loss"]),
                                           rtol=1e-5, err_msg=str(shape))
            for k in LEAVES:
                np.testing.assert_allclose(
                    got["params"][k], np.asarray(getattr(
                        jtr.state.pool.params, k)), atol=5e-6, rtol=1e-4,
                    err_msg=f"{shape}: param {k}")
            np.testing.assert_array_equal(  # denom: before degrees, alive
                got["leaves"][-3], np.asarray(jtr.state.pool.denom))
            assert got["budgets"] == jtr.budgets


def test_sharded_step_has_no_host_transfer(ranks_1x4):
    """What the captured sharded step cannot hold, caught on the gloo
    ranks: one sharded_fused_step per layout (its collectives included)
    makes no tensor from host data and reads no device value on the
    host, outside the kernels' plain versions."""
    for r in ranks_1x4[0]:
        for got in r["host_transfers"]:
            assert got["ops"] > 500 and got["nr"] > 0
            assert not got["bad"], got["bad"]


def test_scaling_bench_graphed_step_equals_eager_steps(ranks_1x2):
    """scaling_bench on (1, 1) and (1, 2) gloo ranks: root's keys, the
    device, ms per step, capture_s (0 on the CPU: no graph) and the loss
    after the window, which equals that of as many eager
    sharded_train_step calls from the same scene, camera and Adam
    scalars."""
    lines = [json.loads(ln) for ln in ranks_1x2[0]["scaling_lines"]]
    assert [rec["mesh"] for rec in lines] == ["1x1", "1x2"]
    for rec, want in zip(lines, ranks_1x2[0]["scaling_eager"]):
        assert sorted(rec) == sorted([
            "mesh", "width", "prims", "device", "ms_per_step",
            "pixels_per_s", "efficiency_vs_1dev", "capture_s", "loss"])
        assert rec["capture_s"] == 0.0 and rec["pixels_per_s"] > 0
        assert rec["loss"] == want
    assert not ranks_1x2[1]["scaling_lines"]  # rank 0 prints
    assert ranks_1x2[0]["scaling_eager"] == ranks_1x2[1]["scaling_eager"]


def test_step_group_refuses_gloo_on_the_card(setup, monkeypatch):
    """A graph asked for under gloo on the card raises, before any camera
    is popped or background drawn: gloo's collectives on CUDA tensors
    cannot be captured.  NCCL groups, or no groups at all, pass."""
    _, scene, _, leaves = setup
    tr = child.sharded_trainer(scene, leaves, "cpu", tsh.make_mesh(1, 1),
                               True)
    tsh.refuse_uncapturable(tr.mesh)  # no groups at all
    tr.mesh.world = tr.mesh.tile = tr.mesh.data = object()
    tr.device = torch.device("cuda")
    draw = tr.rng.bit_generator.state
    monkeypatch.setattr(tsh.dist, "get_backend", lambda g: "gloo")
    with pytest.raises(RuntimeError, match="gloo collectives on CUDA"):
        tr.step_group([1, 2])
    assert tr.rng.bit_generator.state == draw and not tr._stack
    monkeypatch.setattr(tsh.dist, "get_backend", lambda g: "nccl")
    tsh.refuse_uncapturable(tr.mesh)


def test_children_import_no_jax(ranks_1x4, ranks_2x2, ranks_1x2):
    for group in (ranks_1x4[0], ranks_2x2, ranks_1x2):
        assert not any(r["jax_imported"] for r in group)


def test_world_size_one_without_a_process_group(setup):
    """No process group: a (1, 1) mesh with identity collectives gives the
    single-card step's gradients bit for bit in both layouts, and
    ShardedTrainer the single-card Trainer's trace."""
    cams, scene, _, leaves = setup
    assert not torch.distributed.is_initialized()
    mesh = tsh.make_mesh(1, 1)
    assert mesh.world is None and mesh.tile is None and mesh.data is None
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tsh.make_mesh(2, 2)
    cfg = TOpt(**child.REG)
    _, m_1, g_1 = _port_single(setup, cfg, skip_update=True)
    for param_shard in (False, True):
        st = tsh.shard_state(child.state_from(leaves, "cpu"), mesh,
                             param_shard)
        _, m, g = tsh.sharded_train_step(
            st, [_tcam(cams[0])], [torch.as_tensor(np.asarray(
                cams[0].image))], torch.zeros(3), 1, mesh=mesh,
            param_shard=param_shard, skip_update=True,
            **child.step_kw(scene, BUDGET, cfg))
        # the loss's terms are added in another order (1 ulp apart)
        np.testing.assert_allclose(float(m["loss"]), float(m_1["loss"]),
                                   rtol=1e-6)
        for a, b in zip(g_1, g):
            assert torch.equal(a, b)
    kw = dict(sharded=False)
    ref = child.trainer_run(0, 1, torch.device("cpu"), scene,
                            _surgery_leaves(), SURGERY, 5, **kw)
    got = child.trainer_run(0, 1, torch.device("cpu"), scene,
                            _surgery_leaves(), SURGERY, 5)
    assert got["losses"] == ref["losses"]
    for name in LEAVES:
        np.testing.assert_array_equal(got["params"][name],
                                      ref["params"][name])


def test_launch_cli_on_cpu():
    """python -m reduced3dgs_torch.parallel.launch --scaling --device cpu:
    no process group, one JSON line for the (1, 1) mesh, and nothing it
    imports is jax."""
    code = ("import runpy, sys; sys.argv = ['launch', '--scaling', "
            "'--device', 'cpu', '--width', '64', '--prims', '256', "
            "'--iters', '1']; runpy.run_module("
            "'reduced3dgs_torch.parallel.launch', run_name='__main__'); "
            "print('JAX', 'jax' in sys.modules)")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "JAX False"
    rec = json.loads(lines[-2])
    assert rec["mesh"] == "1x1" and rec["width"] == 64
    assert rec["pixels_per_s"] > 0 and rec["efficiency_vs_1dev"] == 1.0
