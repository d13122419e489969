"""Fused steps of the port (Trainer.step_group) against sequential steps
and against the JAX package's step_group, on the CPU.

On the CPU step_group runs the captured step's code (train/trainer.py
fused_step: the state in static buffers, the camera, background, xyz
learning rate and Adam's bias corrections as tensors of one step vector)
in a loop, so it must equal sequential Trainer.step bit for bit: a 0-dim
float32 tensor and a Python float of the same float32 value round alike.
Against the JAX package (tests/test_fused_steps.py's scene, the "xla"
oracle there and the port's "ref" oracle here) the tolerances of
tests/test_fused_steps.py hold: loss per step rtol 1e-5, num_rendered
within 2, parameters rtol 5e-4 / atol 1e-3, budgets equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_fused_steps import _make_trainer as jax_trainer
from test_torch_trainer import make_trainer
from test_training import BUDGET
from test_training import target_scene as jax_scene

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models import gaussians as G
from reduced3dgs_torch.train import trainer as T
from reduced3dgs_tpu.config import OptimizationParams as JOpt
from reduced3dgs_tpu.train.trainer import Trainer as JTrainer


def _state_tensors(tr):
    pool = tr.state.pool
    return T.carried(tr.state) + (pool.degrees, pool.alive)


def _groups(tr, first, last, size):
    ms, it = [], first
    while it <= last:
        got = tr.step_group(range(it, min(it + size, last + 1)))
        ms += got
        it += len(got)
    return ms


@pytest.mark.parametrize("random_background", [False, True])
def test_step_group_equals_sequential_steps(random_background):
    cfg = dict(densify_from_iter=1000, iterations=60,
               random_background=random_background, lambda_alpha_regul=0.01,
               lambda_sh_sparsity=0.01)
    seq = make_trainer(False, **cfg)
    fus = make_trainer(False, **cfg)
    m_seq = [seq.step(i) for i in range(1, 14)]
    m_fus = _groups(fus, 1, 13, 5)
    assert len(m_fus) == 13 and fus.iteration == seq.iteration == 13
    for a, b in zip(m_seq, m_fus):
        assert sorted(a) == sorted(b)
        for k in a:
            assert float(a[k]) == float(b[k]), k
    for a, b in zip(_state_tensors(seq), _state_tensors(fus)):
        assert torch.equal(a, b)
    assert list(seq.state.opt.step) == list(fus.state.opt.step) == [13] * 6
    assert seq.budgets == fus.budgets
    assert seq.rng.uniform() == fus.rng.uniform()  # the same draws taken
    assert fus.graph_captures == 0  # no graph on the CPU


def test_step_group_overflow_redo_equals_sequential():
    """A budget too small for the views: step() redoes the one step, the
    group redoes all of its steps from the saved state.  Both end on the
    same parameters; the group grows only the budgets of the cameras that
    overflowed its shared budget, so its largest budget is step()'s."""
    seq = make_trainer(False, densify_from_iter=1000, iterations=60)
    fus = make_trainer(False, densify_from_iter=1000, iterations=60)
    seq.initial_budget = fus.initial_budget = 64
    for i in range(1, 7):
        seq.step(i)
    before = fus.state
    calls = []
    fused = T.train_steps_fused

    def spy(runner, state, vecs, gts):
        calls.append(state)
        return fused(runner, state, vecs, gts)

    T.train_steps_fused = spy
    try:
        fus.step_group([1, 2, 3])
        fus.step_group([4, 5, 6])
    finally:
        T.train_steps_fused = fused
    assert calls[0] is calls[1] is before  # the redo starts where it began
    assert len(calls) >= 3
    assert max(seq.budgets.values()) == max(fus.budgets.values())
    assert max(fus.budgets.values()) > 64
    for a, b in zip(_state_tensors(seq), _state_tensors(fus)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5,
                                   atol=1e-5)


def test_step_group_resolution_change_ends_the_group():
    """A camera of another size ends the group before it (it is pushed
    back and comes next); step_group rejects non-fusible iterations."""
    tr = make_trainer(False, densify_from_iter=1000, iterations=60)
    order = list(tr.rng.permutation(4))  # the first pass of cameras
    tr.rng = np.random.default_rng(1)
    odd = tr.cameras[order[-3]]  # popped third
    tr.cameras[order[-3]] = Camera.look_at(
        eye=(0, 0, -3), target=(0, 0, 0), width=32, height=32, uid=odd.uid,
        image=np.zeros((32, 32, 3), np.float32))
    ms = tr.step_group([1, 2, 3, 4])
    assert len(ms) == 2 and tr.iteration == 2
    assert tr._stack[-1] == order[-3]
    with pytest.raises(ValueError):
        tr.step_group([59, 60])  # the final iteration never steps


def _port_trainer(jcams, **cfg_over):
    """tests/test_fused_steps.py's _make_trainer on the port: the same
    points, cameras, images and schedule, the "ref" oracle."""
    rng = np.random.default_rng(42)
    pts = rng.uniform(-0.9, 0.9, (32, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (32, 3)).astype(np.float32)
    pool = G.create_from_pcd(pts, cols, capacity=256, device="cpu")
    base = dict(iterations=60, densify_from_iter=1000,
                opacity_reset_interval=10_000)
    base.update(cfg_over)
    cfg = dataclasses.replace(OptimizationParams(), **base)
    cams = [Camera(uid=c.uid, colmap_id=c.colmap_id, R=c.R, T=c.T,
                   fov_x=c.fov_x, fov_y=c.fov_y, image=np.asarray(c.image),
                   image_name=c.image_name, width=c.width, height=c.height)
            for c in jcams]
    tr = T.Trainer(pool, cfg, cams, spatial_lr_scale=3.0,
                   background=torch.zeros(3), backend="ref",
                   initial_budget=BUDGET, seed=1)
    tr.extent = 3.0
    return tr


def _assert_match_jax(jtr, ttr, jms, tms, rtol=5e-4, atol=1e-3):
    assert len(jms) == len(tms)
    for a, b in zip(jms, tms):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=1e-5)
        assert abs(int(a["num_rendered"]) - int(b["num_rendered"])) <= 2
    for la, lb in zip(jax.tree.leaves(jtr.state.pool.params),
                      ttr.state.pool.params):
        np.testing.assert_allclose(lb.numpy(), np.asarray(la), rtol=rtol,
                                   atol=atol)
    assert ttr.budgets == jtr.budgets
    assert list(ttr.state.opt.step) == [
        int(s) for s in jax.tree.leaves(jtr.state.opt.step)]


def test_step_group_matches_jax_step_group():
    jcams = jax_scene()
    jtr, ttr = jax_trainer(jcams), _port_trainer(jcams)
    _assert_match_jax(jtr, ttr, _groups(jtr, 1, 12, 5),
                      _groups(ttr, 1, 12, 5))


def test_step_group_random_background_and_overflow_match_jax():
    """tests/test_fused_steps.py's second case on both packages: random
    backgrounds from the same numpy stream, and an initial budget that
    overflows (64 instances; 512 fits every view of this scene) and the
    budgets the redo grows to."""
    jcams = jax_scene()
    jtr = jax_trainer(jcams, random_background=True)
    ttr = _port_trainer(jcams, random_background=True)
    jtr.initial_budget = ttr.initial_budget = 64
    jms = jtr.step_group([1, 2, 3]) + jtr.step_group([4, 5, 6])
    tms = ttr.step_group([1, 2, 3]) + ttr.step_group([4, 5, 6])
    _assert_match_jax(jtr, ttr, jms, tms)
    assert max(ttr.budgets.values()) > 64


CONFIGS = [
    dict(densify_from_iter=5, densification_interval=10, iterations=60),
    dict(iterations=2000, densify_from_iter=500, densify_until_iter=1500,
         densification_interval=100, opacity_reset_interval=700,
         prune_dead_points=True, white_background=True),
    dict(iterations=1800, densify_from_iter=100, densify_until_iter=900,
         densification_interval=50, mercy_points=True, mercy_interval=3,
         opacity_reset_interval=600, cull=(300, 1200)),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["short", "white", "mercy"])
def test_fusible_matches_jax(cfg):
    cfg = dict(cfg)
    white = cfg.pop("white_background", False)
    cull = cfg.pop("cull", ())
    trainers = []
    for Opt, Tr in ((JOpt, JTrainer), (OptimizationParams, T.Trainer)):
        tr = Tr.__new__(Tr)  # the schedule only; no pool or cameras
        tr.opt_cfg = dataclasses.replace(Opt(), **cfg)
        tr.white_background = white
        tr.cull_sh_iterations = cull
        tr.scene = object()
        tr.fine_tune_start = tr.opt_cfg.iterations
        if cull or tr.opt_cfg.mercy_points:
            tr.fine_tune_start = tr.opt_cfg.iterations - 3000
        trainers.append(tr)
    jtr, ttr = trainers
    want = [jtr.fusible(i) for i in range(1, 2001)]
    got = [ttr.fusible(i) for i in range(1, 2001)]
    assert got == want
    assert 0 < sum(got) < 2000


def test_fused_step_has_no_host_transfer():
    """What a CUDA graph cannot capture, caught on the CPU: the fused step
    (both reduction modes) makes no tensor from host data and reads no
    device value on the host, outside the plain versions of the kernels
    (the card runs the kernels there)."""
    from host_transfers import HostTransfers

    watch = HostTransfers()
    for mode in ("bf16x2", "f32"):
        tr = make_trainer(False, densify_from_iter=1000, iterations=60)
        loop = T.StepLoop(tr.state, dict(
            width=48, height=48, budget=4096, backend="tile",
            opt_cfg=tr.opt_cfg, grad_reduce=mode, active_sh_degree=0))
        loop.buf.load(tr.state)
        loop.buf.vec.copy_(torch.as_tensor(np.concatenate([
            T.camera_vector(tr.cameras[0]), np.zeros(4),
            [0.1 ** i for i in range(1, 13)]]).astype(np.float32)))
        with watch:
            loop.replay()
        assert int(loop.buf.out_i[0]) > 0
    assert not watch.bad, watch.bad


def test_tensor_scalars_round_as_python_floats():
    """train_step with the xyz learning rate and Adam's bias corrections
    as 0-dim float32 tensors (what Trainer.step and the fused step pass)
    gives the bits of the same step with Python floats."""
    tr = make_trainer(False, densify_from_iter=1000, iterations=60,
                      lambda_alpha_regul=0.01)
    for i in range(1, 4):
        tr.step(i)
    cam = tr.cameras[0]
    args = (tr.state, cam.params("cpu"), tr.gt_image(cam), tr.background, 4)
    kw = dict(width=cam.width, height=cam.height, budget=4096,
              backend="tile", opt_cfg=tr.opt_cfg,
              spatial_lr_scale=tr.spatial_lr_scale, grad_reduce="bf16x2")
    sc = torch.as_tensor(tr._adam_scalars(4))
    floats, _ = T.train_step(*args, **kw)
    tensors, _ = T.train_step(*args, adam_scalars=T.adam_scalars(sc), **kw)
    for a, b in zip(T.carried(floats), T.carried(tensors)):
        assert torch.equal(a, b)
    assert float(sc[0]) == T._xyz_lr(4, tr.opt_cfg, tr.spatial_lr_scale)
