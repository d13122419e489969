"""The port's Trainer and training CLI (plain kernel versions on the CPU).

* The store_grads / update-ordering cases of tests/test_store_grads.py
  and the budget ladder of tests/test_training.py, on
  reduced3dgs_torch.train.trainer.Trainer;
* ``python -m reduced3dgs_torch.train --device cpu`` on the tiny Blender
  scene of tests/test_cli_e2e.py; the options it does not have yet are
  refused up front, and without --device it needs a card.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_cli_e2e import REPO, make_blender_dataset

from reduced3dgs_torch.cameras import Camera
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models import gaussians as G
from reduced3dgs_torch.renderer import render
from reduced3dgs_torch.train import __main__ as train_cli
from reduced3dgs_torch.train.trainer import Trainer

W = H = 48
BUDGET = 4096


def target_scene(seed=0, n=24):
    """Ground-truth Gaussians rendered by the port from four viewpoints
    (tests/test_training.py:target_scene)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, 0] = rng.uniform(-1.0, 1.5, (n, 3))
    scales = np.log(rng.uniform(0.1, 0.25, (n, 3))).astype(np.float32)
    rots = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(1.0, 3.0, n).astype(np.float32)
    deg = np.zeros(n, np.int32)
    cams = [Camera.look_at(eye=e, target=(0, 0, 0), width=W, height=H,
                           uid=i)
            for i, e in enumerate([(0, 0, -3), (2.1, 0, -2.1),
                                   (-2.1, 0.3, -2.1), (0, 2.1, -2.1)])]
    arrs = [torch.as_tensor(a) for a in (xyz, feats, scales, rots, opac,
                                         deg)]
    for cam in cams:
        with torch.no_grad():
            out = render(*arrs, cam.params("cpu"), torch.zeros(3), width=W,
                         height=H, instance_budget=BUDGET)
        cam.image = np.clip(out.color.numpy(), 0, 1)
    return cams


def make_trainer(store_grads, **cfg_kw):
    cams = target_scene()
    rng = np.random.default_rng(7)
    pts = rng.uniform(-0.9, 0.9, (32, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (32, 3)).astype(np.float32)
    pool = G.create_from_pcd(pts, cols, capacity=256, device="cpu")
    kw = dict(iterations=30, densify_from_iter=2, densification_interval=5,
              opacity_reset_interval=10_000, densify_grad_threshold=1e-7,
              percent_dense=10.0, store_grads=store_grads)
    kw.update(cfg_kw)
    cfg = dataclasses.replace(OptimizationParams(), **kw)
    tr = Trainer(pool, cfg, cams, spatial_lr_scale=3.0,
                 background=torch.zeros(3), backend="tile",
                 initial_budget=BUDGET, seed=1, grad_reduce="bf16x2")
    tr.extent = 3.0
    return tr


def steps_of(tr):
    return list(tr.state.opt.step)


def test_no_store_grads_skips_step_on_densify_iteration():
    tr = make_trainer(store_grads=False)
    for it in range(1, 5):
        tr.step(it)
    assert steps_of(tr) == [4] * 6
    alive_before = tr.state.pool.alive.clone()
    xyz_before = tr.state.pool.params.xyz.clone()
    tr.step(5)  # densify iteration: surgery, but no Adam step
    assert steps_of(tr) == [4] * 6
    pool = tr.state.pool
    assert int(pool.num_alive) > int(alive_before.sum())
    assert torch.equal(pool.params.xyz[alive_before],
                       xyz_before[alive_before])


def test_store_grads_applies_step_after_surgery():
    tr = make_trainer(store_grads=True)
    for it in range(1, 5):
        tr.step(it)
    assert steps_of(tr) == [4] * 6
    alive_before = tr.state.pool.alive.clone()
    tr.step(5)  # densify iteration: surgery, then the deferred step
    assert steps_of(tr) == [5] * 6
    pool = tr.state.pool
    new_rows = pool.alive & ~alive_before
    assert bool(new_rows.any())
    assert bool(torch.isfinite(pool.params.xyz[new_rows]).all())


def test_final_iteration_never_steps():
    tr = make_trainer(store_grads=False, iterations=3,
                      densify_from_iter=100)
    tr.step(1)
    tr.step(2)
    assert steps_of(tr) == [2] * 6
    xyz_before = tr.state.pool.params.xyz.clone()
    tr.step(3)
    assert steps_of(tr) == [2] * 6
    assert torch.equal(tr.state.pool.params.xyz, xyz_before)


def test_white_bg_reset_steps_all_but_opacity():
    tr = make_trainer(store_grads=False, iterations=30,
                      densify_from_iter=3, densification_interval=1000)
    tr.white_background = True
    tr.step(1)
    tr.step(2)
    assert steps_of(tr) == [2] * 6
    tr.step(3)  # white-background opacity reset at densify_from_iter
    steps = dict(zip(G.GaussianParams._fields, steps_of(tr)))
    assert steps["opacity"] == 2
    assert all(v == 3 for k, v in steps.items() if k != "opacity")
    pool = tr.state.pool
    assert bool((pool.get_opacity()[pool.alive] <= 0.0100001).all())


def test_budget_ladder_growth():
    tr = Trainer.__new__(Trainer)  # ladder logic only; no training state
    tr.budgets = {}
    tr.initial_budget = 1 << 17
    assert tr._budget_for(0) == 1 << 17
    assert tr._budget_for(0, needed=(1 << 17) + 1) == 3 << 16
    assert tr._budget_for(0, needed=(3 << 16) + 1) == 1 << 18
    assert tr._budget_for(0, needed=1_500_000) == 3 << 19
    assert all(b % 128 == 0 for b in tr.budgets.values())
    assert tr._budget_for(1) == 1 << 17


def test_unported_trainer_options_raise():
    cams = target_scene(n=4)
    pool = G.empty_pool(1024, "cpu")
    with pytest.raises(NotImplementedError):
        Trainer(pool, OptimizationParams(mercy_points=True), cams,
                spatial_lr_scale=1.0, background=torch.zeros(3))
    with pytest.raises(NotImplementedError):
        Trainer(pool, OptimizationParams(), cams, spatial_lr_scale=1.0,
                background=torch.zeros(3), cull_sh_iterations=(5,))
    tr = Trainer(pool, OptimizationParams(), cams, spatial_lr_scale=1.0,
                 background=torch.zeros(3))
    with pytest.raises(NotImplementedError):
        tr.step_group([1, 2])


@pytest.mark.parametrize("flags", [["--mercy_points"], ["--cull_SH", "9"],
                                   ["--start_checkpoint", "x.npz"],
                                   ["--checkpoint_iterations", "5"],
                                   ["--variable_sh_bands"],
                                   ["--fused_steps", "4"]])
def test_cli_refuses_unported_flags(flags, tmp_path):
    with pytest.raises(NotImplementedError):
        train_cli.main(["-s", str(tmp_path), "--device", "cpu", *flags])


def test_cli_needs_card_or_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m")])


def test_train_cli_on_cpu(tmp_path):
    """30 iterations with a densify at 15 and 25 (bf16x2 reduction, the
    default), saving at 20 and at the end."""
    src = os.path.join(tmp_path, "scene")
    make_blender_dataset(src)
    model = os.path.join(tmp_path, "model")
    r = subprocess.run(
        [sys.executable, "-m", "reduced3dgs_torch.train", "-s", src, "-m",
         model, "--device", "cpu", "--iterations", "30",
         "--densify_from_iter", "10", "--densification_interval", "5",
         "--save_iterations", "20", "--test_iterations", "30"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert "not ported yet and was not run" in lines[-1]
    assert any("Evaluating train" in ln for ln in lines)
    for it in (20, 30):
        assert os.path.exists(os.path.join(
            model, "point_cloud", f"iteration_{it}", "point_cloud.ply"))
    for name in ("cfg_args", "cameras.json", "input.ply"):
        assert os.path.exists(os.path.join(model, name))
    losses = [float(ln.split()[3]) for ln in lines
              if ln.startswith("[ITER") and " loss " in ln]
    assert len(losses) == 3 and np.isfinite(losses).all()
