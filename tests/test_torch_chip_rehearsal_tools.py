"""chip_smoke.py's phases 17 and 18 rehearsed on the CPU at a tiny size
(tests/chip_rehearsal.py).

Phase 17: part 1, ShardedTrainer.step_group at world size 1 in a gloo
group (its CPU loop in place of the NCCL graph) against the eager steps
in both layouts; part 2, outside the group, the scaling harness's loop
beside its eager run, profile_components and profile_trace in process and
the two microbenchmarks as subprocesses; the path's launch counts without
the references'.

Phase 18 (one run, a module fixture): python -m
reduced3dgs_torch.compression_eval and fps_table at 64x64, 2 / 1 views
and 15 iterations, their training and render subprocesses started through
tests/plain_child.py (the plain versions counting launches as the kernels
do); the same run is held to the JAX script (experiments/
compression_eval.py): its ground-truth PNGs against the JAX make_scene's
(uint8 within 1 on >= 99.9 % of the pixels), its scores against the JAX
evaluate on the same model directories (PSNR within 0.01 dB, SSIM within
1e-4, bytes and primitives equal), its flags, columns and row tags equal
to the JAX script's, and nothing written outside its root.
"""

import ast
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chip_rehearsal import SMALL, cpu_card, cpu_card_patches  # noqa: F401
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch import compression_eval as ce
from reduced3dgs_torch import profile_components
from reduced3dgs_torch.data.png import read_png
from reduced3dgs_torch.graphs import all_kernel_counters, kernel_counters
from reduced3dgs_torch.parallel import launch

HERE = os.path.dirname(os.path.abspath(__file__))


def test_phase17_rehearsal(cpu_card, monkeypatch, capsys):
    """Phase 17 at 48x32 with 600 primitives, groups of 2, one round in
    turns and a budget of 256 that overflows, the tools at 48x32 with 256
    primitives and the microbenchmarks at a few thousand rows, in one
    intra-op thread."""
    from reduced3dgs_torch.parallel.sharded import make_mesh

    monkeypatch.setattr(cs, "MAIN", dict(SMALL, width=48, height=32,
                                         n=600))
    monkeypatch.setattr(cs, "SHARDED", dict(group=2, rounds=1,
                                            overflow_budget=1 << 8))
    monkeypatch.setattr(cs, "SCALING", dict(width=64, prims=256, iters=1))
    monkeypatch.setattr(cs, "TOOLS", (48, 32, 256, 1 << 13))
    monkeypatch.setattr(cs, "TRACE", dict(iters=1, top=5,
                                          scales=(0.02, 0.08)))
    monkeypatch.setattr(cs, "MICRO_ARGS", {
        "microbench_gather": ("--rows", "2048", "--batch", "4096",
                              "--iters", "2"),
        "microbench_binning": ("--batch", "4096", "--prims", "512")})
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(profile_components, "REPS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # the launches of the references the path is held to and of the
    # ground truth's renders, apart
    excluded = {}
    eager_steps, bench = cs.run_steps_eager, launch.scaling_bench
    truth = cs.train_cameras

    def counted_truth(*a, **kw):
        with cs.launches_into(excluded):
            return truth(*a, **kw)

    def counted_eager_steps(*a):
        with cs.launches_into(excluded):
            return eager_steps(*a)

    def counted_bench(*a, eager=False, **kw):
        with cs.launches_into(excluded if eager else {}):
            return bench(*a, eager=eager, **kw)

    monkeypatch.setattr(cs, "run_steps_eager", counted_eager_steps)
    monkeypatch.setattr(launch, "scaling_bench", counted_bench)
    monkeypatch.setattr(cs, "train_cameras", counted_truth)
    try:
        with cs.world_of_one("gloo"):
            groups = [cs.group_under_gloo(cpu_card, make_mesh(1, 1))] * 2
            acc = cs.sharded_group_path(cpu_card, 0, "cpu", groups)
        cs.sharded_tools_path(cpu_card, "cpu", acc)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    # the path's counts leave out the eager steps and the eager scaling
    # run, which did launch every kernel they reach, and the set-up
    total = {n: k.launches for n, k in kernel_counters().items()}
    printed = ast.literal_eval(out.split(
        "phase 17: launches of the path (")[1].split(") ", 1)[1]
        .splitlines()[0])
    assert printed == acc == {n: total[n] - excluded[n] for n in total}
    assert all(v > 0 for v in acc.values())
    assert excluded["expand"] > 0 and excluded["seg_reduce_packed"] > 0
    assert excluded["seg_reduce_f32"] > 0
    for layout in ("replicated", "param_shard"):
        what = f"gloo at world size 1, {layout}, bf16x2, 48x32"
        assert (f"{what}: a group of 2 replayed from one graph (0 capture"
                in out)
        assert "every metric and leaf bit for bit" in out
        assert f"{what}: from budgets of 256: the group re-ran" in out
        assert f"{what}: ms per step" in out
    # the single-card graphed group on the same pool, in the replicated
    # layout's turns only
    assert out.count("; single-card graphed ") == 1
    assert "two gloo ranks (cpu): [('ran'" in out
    assert out.count("phase 17: scaling_bench graphed {") == 1
    assert out.count("phase 17: profile_components: ") == 7
    assert "phase 17: profile_trace: num_rendered=" in out
    assert "(other " in out
    assert out.count("phase 17: microbench_gather: w=") == 9
    assert out.count("phase 17: microbench_binning: ") == 17
    assert "phase 17: launches of the path" in out


# phase 18 at toy size: the schedule scaled to 15 iterations (densify
# from 1 to 8, opacity reset and a test at 4, the cull at 9, the end at
# 15) with a densification interval of 4 (every iteration at the scaled
# 1), the full config's mercy every interval (at 8), the SH degree up
# every 3 iterations (degree 3 at the cull, which at degree 0 demotes
# every primitive to black, as in the reference) and mercy up to 6
# iterations before the end; iterations 1-2, 10-11 and 13-14 form step
# groups in both configurations
TOY = dict(iterations=15, size=64, n_train=2, n_test=1)
CHILD = [sys.executable, os.path.join(HERE, "plain_child.py"),
         "--sh_interval", "3", "--fine_tune", "6"]


@pytest.fixture(scope="module")
def phase18(tmp_path_factory):
    """One phase-18 run into a temporary root, kept for the checks; the
    launches in this process outside the path (the untrained pool's
    reference renders) apart."""
    root = str(tmp_path_factory.mktemp("phase18") / "run")
    results_md = os.path.join(cs.REPO, "RESULTS.md")
    stat = lambda p: (open(p, "rb").read(), os.stat(p).st_mtime_ns)  # noqa
    before_md, had_default = stat(results_md), os.path.exists(
        ce.DEFAULT_ROOT)
    kernels = all_kernel_counters()
    excluded = {}
    scaled = ce.scaled
    untrained = cs.untrained_psnr
    with pytest.MonkeyPatch.context() as mp:
        cpu_card_patches(mp)
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setattr(ce, "module_command", lambda module: CHILD + [module])
        mp.setattr(ce, "scaled", lambda args, it: scaled(args, it) + [
            "--densification_interval", "4"])
        mp.setitem(ce.CONFIGS, "full",
                   ce.CONFIGS["full"] + ["--mercy_interval", "1"])

        def counted_untrained(*a):
            before = {n: k.launches for n, k in kernels.items()}
            try:
                return untrained(*a)
            finally:
                excluded.update({n: k.launches - before[n]
                                 for n, k in kernels.items()})

        mp.setattr(cs, "untrained_psnr", counted_untrained)
        before = {n: k.launches for n, k in kernels.items()}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launches = cs.eval_path(torch.device("cpu"), root, 0, "cpu",
                                    cfg=TOY, keep=True)
        own = {n: k.launches - before[n] - excluded[n]
               for n, k in kernels.items()}
    assert stat(results_md) == before_md
    assert os.path.exists(ce.DEFAULT_ROOT) == had_default
    return dict(root=root, launches=launches, own=own, out=out.getvalue())


def test_phase18_rehearsal(phase18):
    """The phase's lines, its checks passed, and its counts the path's
    own: this process's launches on the path (the ground truth and the
    scoring renders, not the untrained pool's) plus those the two
    training and three render subprocesses logged, the trainings' equal
    to what their train_stats.json recorded."""
    out, root = phase18["out"], phase18["root"]
    for name in ("vanilla", "full"):
        assert f"phase 18: training {name}: " in out
    assert "phase 18: 64x64, 2 / 1 views, 15 iterations: " in out
    assert "full/baseline features_rest exactly 0: " in out
    assert "phase 18: native COLMAP reader (libr3dgs_io-" in out
    printed = ast.literal_eval(out.split(
        "phase 18: launches of the path (")[1].split(") ", 1)[1]
        .split("; ")[0])
    logged, procs = cs.logged_launches(os.path.join(root,
                                                    "launches.jsonl"))
    assert procs == {"train": 2, "render": 3}
    own = phase18["own"]
    assert printed == phase18["launches"] == {
        n: own[n] + logged[n] for n in own}
    assert own["expand"] == own["tile_fwd"] > 0 and own["tile_bwd"] == 0
    with open(os.path.join(root, "results.json")) as f:
        runs = json.load(f)["runs"]
    trained = {n: sum(r["launches"][n] for r in runs.values())
               for n in own}
    with open(os.path.join(root, "launches.jsonl")) as f:
        train_lines = [json.loads(line)["launches"] for line in f
                       if json.loads(line)["what"] == "train"]
    assert {n: sum(t[n] for t in train_lines) for n in own} == trained
    assert trained["tile_trans"] > 0 and trained["seg_reduce_f32"] == 0
    assert {n: r["grouped_steps"] for n, r in runs.items()} == {
        "vanilla": 8, "full": 6}
    for r in runs.values():  # loops here, replayed graphs on a card
        assert r["graph_captures"] == 0
        assert not any(r["graph_launches"].values())
    assert runs["full"]["events"] == {"densify": 1, "reset": 1,
                                      "prune_dead": 2, "mercy": 1,
                                      "cull": 1}


def _jax_script():
    sys.path.insert(0, os.path.join(cs.REPO, "experiments"))
    try:
        import compression_eval as jce
    finally:
        sys.path.pop(0)
    return jce


def test_compression_eval_scene_matches_jax(phase18, tmp_path):
    """The port's ground truth (its renderer on the JAX script's world and
    cameras) against the JAX make_scene's at the same size."""
    jce = _jax_script()
    jroot = str(tmp_path / "jax_scene")
    jce.make_scene(jroot, n_train=TOY["n_train"], n_test=TOY["n_test"],
                   size=TOY["size"], seed=0)
    troot = os.path.join(phase18["root"], "scene")
    for split, n in (("train", TOY["n_train"]), ("test", TOY["n_test"])):
        for i in range(n):
            a = read_png(os.path.join(troot, split, f"r_{i}.png"))
            b = read_png(os.path.join(jroot, split, f"r_{i}.png"))
            assert a.shape == b.shape == (TOY["size"], TOY["size"], 3)
            diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
            assert diff.max() <= 255 and (diff <= 1).mean() >= 0.999, \
                (split, i, (diff <= 1).mean())
        with open(os.path.join(troot, f"transforms_{split}.json")) as f:
            got = json.load(f)
        with open(os.path.join(jroot, f"transforms_{split}.json")) as f:
            want = json.load(f)
        assert got["camera_angle_x"] == want["camera_angle_x"]
        for fa, fb in zip(got["frames"], want["frames"], strict=True):
            assert fa["file_path"] == fb["file_path"]
            np.testing.assert_allclose(fa["transform_matrix"],
                                       fb["transform_matrix"], atol=1e-12)
    with open(os.path.join(troot, "points3d.ply"), "rb") as f:
        got = f.read()
    with open(os.path.join(jroot, "points3d.ply"), "rb") as f:
        assert got == f.read()


def test_compression_eval_evaluate_matches_jax(phase18, monkeypatch):
    """The port's scores of the four variants of both models against the
    JAX evaluate on the same model directories."""
    jce = _jax_script()
    monkeypatch.setattr(jce, "ITER", TOY["iterations"])
    with open(os.path.join(phase18["root"], "results.json")) as f:
        got = json.load(f)["results"]
    data = os.path.join(phase18["root"], "scene")
    for cfg in jce.CONFIGS:
        want = jce.evaluate(data, os.path.join(phase18["root"],
                                               f"model_{cfg}"))
        assert list(got[cfg]) == list(want)
        for tag, w in want.items():
            g = got[cfg][tag]
            assert abs(g["psnr"] - w["psnr"]) <= 0.01, (cfg, tag)
            assert abs(g["ssim"] - w["ssim"]) <= 1e-4, (cfg, tag)
            assert (g["bytes"], g["n_primitives"]) == (
                w["bytes"], w["n_primitives"]), (cfg, tag)


def test_compression_eval_table_is_the_jax_scripts(phase18):
    """The same training flags, configurations and scored variants as the
    JAX script, and its table's columns and row tags in <root>/RESULTS.md
    (and the FPS table's after it)."""
    jce = _jax_script()
    assert ce._COMMON == jce._COMMON and ce.CONFIGS == jce.CONFIGS
    assert ce.ITER == jce.ITER
    with open(os.path.join(cs.REPO, "experiments", "compression_eval.py")) \
            as f:
        jsrc = f.read()
    header = ("| config / model | PSNR (dB) | SSIM | primitives | "
              "size (MB) | x vs vanilla PLY |")
    assert '"| config / model | PSNR (dB) | SSIM | primitives | "' in jsrc
    assert '"size (MB) | x vs vanilla PLY |"' in jsrc
    with open(os.path.join(phase18["root"], "RESULTS.md")) as f:
        lines = f.read().splitlines()
    i = lines.index(header)
    assert lines[i + 1] == "|---|---|---|---|---|---|"
    tags = [line.split(" | ")[0][2:] for line in lines[i + 2:i + 10]]
    assert tags == [f"{c} / {t}" for c in jce.CONFIGS
                    for t in ("baseline", "quantised", "quantised_half",
                              "quantised_pack")]
    assert lines[i + 10] == ""
    assert lines[i + 11].startswith("**Headline**: full_final + "
                                    "quantised_half is **")
    j = lines.index("| model | FPS | x vs vanilla |")
    assert [line.split(" | ")[0][2:] for line in lines[j + 2:j + 8]] == [
        "vanilla/baseline", "full/baseline", "full/quantised",
        "full/quantised_half", "full/quantised_half+variable_sh",
        "full/quantised_pack"]


def test_fps_table_rows_and_files(phase18):
    """fps_table's rows, its JSON beside RESULTS.md, and every file of the
    run under its root (the two models, the scene, the tables and the
    launch log); the repository's RESULTS.md is untouched (the fixture
    checks it)."""
    root = phase18["root"]
    with open(os.path.join(root, "fps_table.json")) as f:
        rows = json.load(f)["fps"]
    assert len(rows) == 6 and all(v > 0 for v in rows.values())
    assert sorted(os.listdir(root)) == [
        "RESULTS.md", "colmap_bin", "fps_table.json", "launches.jsonl",
        "model_full", "model_vanilla", "results.json", "scene"]
    for cfg in ("vanilla", "full"):
        assert os.path.exists(os.path.join(root, f"model_{cfg}",
                                           "fps_results.json"))
