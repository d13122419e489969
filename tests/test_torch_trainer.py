"""The port's Trainer and training CLI (plain kernel versions on the CPU).

* The store_grads / update-ordering cases of tests/test_store_grads.py
  and the budget ladder of tests/test_training.py, on
  reduced3dgs_torch.train.trainer.Trainer;
* ``python -m reduced3dgs_torch.train --device cpu`` on the tiny Blender
  scene of tests/test_cli_e2e.py with the paper's compression flags
  (--cull_SH, --std_threshold 0.04, --cdist_threshold 6, --mercy_points):
  it ends with the final compression's four PLYs, which
  ``python -m reduced3dgs_torch.render --variable_sh_bands`` renders; its
  cfg_args are root train.py's for the same command line (parse only),
  and without --device both need a card.

The CLI runs in subprocesses with one OpenMP thread each: under several
test workers, each with its own full thread pools, a subprocess with a
default-sized pool spends its time in the pool's spin-wait barriers (a run
of seconds took many minutes and overran its limit).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_cli_e2e import REPO, make_blender_dataset

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
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


@pytest.mark.parametrize("needed", [None, (1 << 17) + 1, (3 << 16) + 1,
                                    1_500_000])
def test_budget_for_lands_on_next_budgets_rung(needed):
    """One ladder: Trainer._budget_for climbs renderer.next_budget, which
    render.py names too."""
    from reduced3dgs_torch import render as R, renderer

    assert R.next_budget is renderer.next_budget
    tr = Trainer.__new__(Trainer)
    tr.budgets = {}
    tr.initial_budget = 1 << 17
    assert tr._budget_for(0, needed) == renderer.next_budget(1 << 17,
                                                             needed or 0)


def test_unported_trainer_options_raise():
    """step_group refuses an iteration that is not fusible (here the SH
    degree step at 1000); mercy_points and cull_sh_iterations are accepted
    and set the fine-tune limit (no mercy in the last 3000 iterations).
    Mercy needs no dataset Scene: the Trainer's own cameras give the
    redundancy metric."""
    cams = target_scene(n=4)
    pool = G.empty_pool(1024, "cpu")
    tr = Trainer(pool, OptimizationParams(mercy_points=True), cams,
                 spatial_lr_scale=1.0, background=torch.zeros(3))
    assert tr.fine_tune_start == OptimizationParams().iterations - 3000
    assert tr._events(1000)[3] and not tr._events(1001)[3]
    assert tr.events_at(1000) == ("densify", "mercy")
    assert not tr._events(3000)[3]  # an opacity-reset iteration
    assert not tr._events(28000)[3]  # past the fine-tune limit
    tr = Trainer(pool, OptimizationParams(), cams, spatial_lr_scale=1.0,
                 background=torch.zeros(3), cull_sh_iterations=(5,))
    assert tr.cull_sh_iterations == (5,)
    assert tr.fine_tune_start == OptimizationParams().iterations - 3000
    tr = Trainer(pool, OptimizationParams(), cams, spatial_lr_scale=1.0,
                 background=torch.zeros(3))
    assert tr.fine_tune_start == OptimizationParams().iterations
    assert not tr.fusible(1000) and tr.fusible(999)
    with pytest.raises(ValueError, match="not all fusible"):
        tr.step_group([999, 1000])


def test_trainer_cull_demotes_flat_primitives():
    """cull_sh_iterations=(5,): the step at 5 ends with the SH-band cull.
    The scene's colours are DC-only, so every alive primitive falls to
    degree 0 at the paper's thresholds, and training goes on."""
    tr = make_trainer(store_grads=False, densify_from_iter=100,
                      std_threshold=0.04, cdist_threshold=6.0)
    tr.cull_sh_iterations = (5,)
    pool = tr.state.pool
    tr.state = tr.state._replace(pool=pool.replace(
        degrees=torch.where(pool.alive, 3, 0).to(torch.int32),
        active_sh_degree=3))
    for it in range(1, 5):
        tr.step(it)
    alive = tr.state.pool.alive
    assert bool((tr.state.pool.degrees[alive] == 3).all())
    tr.step(5)
    pool = tr.state.pool
    assert bool((pool.degrees[alive] == 0).all())
    assert not pool.params.features_rest[alive].any()
    assert steps_of(tr) == [5] * 6  # the step itself was applied first
    tr.step(6)
    assert steps_of(tr) == [6] * 6


@pytest.mark.parametrize("flags", [["--start_checkpoint", "x.npz"],
                                   ["--checkpoint_iterations", "5"],
                                   ["--variable_sh_bands"],
                                   ["--fused_steps", "4"]])
def test_cli_refuses_unported_flags(flags, tmp_path):
    """The CLI refuses none of root train.py's flags: the checkpoint
    flags and --fused_steps are ported, --variable_sh_bands (a rendering
    option) is accepted, recorded and ignored as root does."""
    args = train_cli.build_parser().parse_args(
        ["-s", str(tmp_path), "--device", "cpu", *flags])
    cfg = vars(train_cli.cfg_namespace(args))
    assert "device" not in cfg
    assert (args.start_checkpoint == "x.npz" or args.checkpoint_iterations
            == [5] or args.fused_steps == 4 or cfg["variable_sh_bands"])


@pytest.mark.parametrize("flags", [["--mercy_points"], ["--cull_SH", "9"]])
def test_cli_accepts_compression_flags(flags, tmp_path):
    args = train_cli.build_parser().parse_args(
        ["-s", str(tmp_path), "--device", "cpu", *flags])
    assert args.mercy_points or args.cull_SH == [9]


class _Dumped(Exception):
    """Raised by the cfg_args capture: nothing after the dump runs."""


def _cfg_args_of(main, config_module, argv, monkeypatch):
    """The cfg_args text that a training CLI's main writes for argv; the
    run stops at the dump (parse only)."""
    seen = []

    def capture(model_path, args):
        seen.append(str(args))
        raise _Dumped

    monkeypatch.setattr(config_module, "dump_cfg_args", capture)
    with pytest.raises(_Dumped):
        main(argv)
    return seen[0]


def test_cli_cfg_args_equal_root(tmp_path, monkeypatch):
    """For a root command line that carries --variable_sh_bands, the
    port's training CLI writes root train.py's cfg_args, the compositor's
    name apart."""
    import importlib.util

    from reduced3dgs_torch import config as TC
    from reduced3dgs_tpu import config as JC
    from reduced3dgs_tpu import platform as jplatform

    spec = importlib.util.spec_from_file_location(
        "root_train", os.path.join(REPO, "train.py"))
    root_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_train)
    monkeypatch.setattr(jplatform, "setup", lambda *a, **k: None)
    argv = ["-s", str(tmp_path / "scene"), "-m", str(tmp_path / "m"),
            "--eval", "--iterations", "300", "--variable_sh_bands",
            "--lambda_sh_sparsity", "0.1", "--cull_SH", "200",
            "--mercy_points", "--fused_steps", "16",
            "--test_iterations", "100", "300"]

    def root_main(a):
        monkeypatch.setattr(sys, "argv", ["train.py"] + a)
        root_train.main()

    want = _cfg_args_of(root_main, JC, argv, monkeypatch)
    got = _cfg_args_of(train_cli.main, TC, argv + ["--device", "cpu"],
                       monkeypatch)
    assert "variable_sh_bands=True" in want
    # the compositor's default keeps each package's own name: the JAX
    # package's "pallas" is the port's "tile" (and "xla" its "ref")
    assert "backend='pallas'" in want and "backend='tile'" in got
    assert got.replace("backend='tile'", "backend='pallas'") == want


def test_cli_needs_card_or_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m")])


ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
FINAL_PLYS = ("point_cloud.ply", "point_cloud_quantised.ply",
              "point_cloud_quantised_half.ply",
              "point_cloud_quantised_pack.ply")


def _run_cli(module, args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO,
        env=dict(os.environ, **ONE_THREAD), capture_output=True, text=True,
        timeout=timeout)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One CLI training with the paper's compression flags: 20
    iterations, a densify at 10 and 15, an SH cull at 16, saves at 12 and
    at the end (bf16x2 reduction, the default)."""
    root = tmp_path_factory.mktemp("torch_train_cli")
    src = os.path.join(root, "scene")
    make_blender_dataset(src)
    model = os.path.join(root, "model")
    r = _run_cli("reduced3dgs_torch.train", [
        "-s", src, "-m", model, "--device", "cpu", "--iterations", "20",
        "--densify_from_iter", "5", "--densification_interval", "5",
        "--save_iterations", "12", "--test_iterations", "20",
        "--cull_SH", "16", "--std_threshold", "0.04",
        "--cdist_threshold", "6", "--mercy_points"])
    return model, r


def test_train_cli_on_cpu(trained):
    model, r = trained
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("Training complete in")
    assert any("Evaluating train" in ln for ln in lines)
    final = [ln for ln in lines if ln.startswith("Final compression")]
    assert len(final) == 1 and all(n in final[0] for n in FINAL_PLYS)
    assert os.path.exists(os.path.join(
        model, "point_cloud", "iteration_12", "point_cloud.ply"))
    for name in ("cfg_args", "cameras.json", "input.ply"):
        assert os.path.exists(os.path.join(model, name))
    losses = [float(ln.split()[3]) for ln in lines
              if ln.startswith("[ITER") and " loss " in ln]
    assert len(losses) == 2 and np.isfinite(losses).all()
    # the final compression: the four files exist and load to one size,
    # with degrees the cull at 16 has demoted
    from reduced3dgs_torch.models.ply_io import load_gaussian_ply

    pc = os.path.join(model, "point_cloud", "iteration_20")
    assert sorted(os.listdir(pc)) == sorted(FINAL_PLYS)
    sizes = set()
    for name in FINAL_PLYS:
        q = "quantised" in name
        arrs = load_gaussian_ply(os.path.join(pc, name), quantised=q,
                                 half_float="half" in name or "pack" in name)
        sizes.add(arrs["xyz"].shape[0])
        assert all(np.isfinite(v).all() for v in arrs.values())
        assert arrs["degrees"].max() == 0  # DC-only scene: all demoted
    assert len(sizes) == 1 and sizes.pop() > 32


def test_render_cli_variable_sh_on_trained_model(trained):
    """--variable_sh_bands renders the compressed files of the last
    iteration, and the save at 12, to the images the dense path writes
    (within one 8-bit level).  The cull at 16 runs long before the SH
    degree is raised (every 1000 iterations), where the reference's
    statistics take a primitive's full-degree colour as 0: the final
    model is black by that rule, so the save at 12 carries the check
    that the images show the scene."""
    from PIL import Image

    model, r = trained
    assert r.returncode == 0, r.stderr[-3000:]
    outs = {}
    for iteration, models in ((20, ["quantised_half", "quantised_pack"]),
                              (12, ["baseline"])):
        for flag in ([], ["--variable_sh_bands"]):
            r = _run_cli("reduced3dgs_torch.render", [
                "-m", model, "--device", "cpu", "--skip_test",
                "--skip_measure_fps", "--iteration", str(iteration),
                "--models", *models, *flag])
            assert r.returncode == 0, r.stderr[-3000:]
            for variant in models:
                d = os.path.join(model, "train", variant,
                                 f"ours_{iteration}", "renders")
                names = sorted(os.listdir(d))
                assert len(names) == 6  # without --eval every view trains
                imgs = []
                for n in names:
                    with Image.open(os.path.join(d, n)) as im:
                        imgs.append(np.asarray(im).astype(int))
                outs[variant, bool(flag)] = np.stack(imgs)
    for variant in ("quantised_half", "quantised_pack", "baseline"):
        a, b = outs[variant, False], outs[variant, True]
        assert a.shape == b.shape == (6, 64, 64, 3)
        assert np.abs(a - b).max() <= 1
    assert outs["baseline", True].max() > 50


def test_cli_trace_writes_the_snapshot(trained, tmp_path):
    """--trace (utils/profiling.py on for the run) puts the snapshot under
    "trace": the training CLI's train_stats.json (every train stage once
    an iteration, the step-group spans, the counters), the render CLI's
    fps_results.json (the view stages once a render)."""
    import json
    import shutil

    model, r = trained
    assert r.returncode == 0, r.stderr[-3000:]
    src = os.path.join(os.path.dirname(model), "scene")
    out = str(tmp_path / "traced")
    r = _run_cli("reduced3dgs_torch.train", [
        "-s", src, "-m", out, "--device", "cpu", "--iterations", "8",
        "--fused_steps", "4", "--save_iterations", "8",
        "--test_iterations", "100", "--trace"])
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(out, "train_stats.json")) as f:
        trace = json.load(f)["trace"]
    stages = trace["stages"]
    assert {n: s["count"] for n, s in stages.items()} == dict.fromkeys(
        ("preprocess", "binning", "composite", "loss", "loss_bwd", "tile_bwd",
         "reduce", "preprocess_bwd", "adam", "store"), 8)
    assert trace["spans"]["r3dgs.step_group.replays"]["calls"] >= 1
    assert trace["counters"]["num_rendered"]["count"] == 8
    assert trace["stamps_dropped"] == 0
    view = str(tmp_path / "view")
    shutil.copytree(model, view)
    r = _run_cli("reduced3dgs_torch.render", [
        "-m", view, "--device", "cpu", "--skip_test", "--skip_measure_fps",
        "--iteration", "12", "--models", "baseline", "--trace"])
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(view, "fps_results.json")) as f:
        trace = json.load(f)["trace"]
    renders = trace["counters"]["num_rendered"]["count"]
    assert renders >= 6  # the six training views, redone on overflow
    assert {n: s["count"] for n, s in trace["stages"].items()} == \
        dict.fromkeys(("preprocess", "binning", "composite"), renders)
