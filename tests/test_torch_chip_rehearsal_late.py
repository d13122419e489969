"""chip_smoke.py's later phases rehearsed on the CPU at a tiny size
(tests/chip_rehearsal.py): the trainer of phase 9 into phase 12's
compression, the fused steps, checkpoints and offline CLIs of phases
13-14, the multi-device path of phase 15 and phase 16's graphed ring and
bench step, viewer frame and evaluation CLIs.  step_group, the ring and the bench
step run their CPU loops here, not graphs, and the profiled group or
replay counts the plain versions' launches instead of kernel names."""

import os

import numpy as np

import chip_smoke as cs
from chip_rehearsal import SMALL, counted, cpu_card  # noqa: F401


def test_phase9_and_12_rehearsal(cpu_card, tmp_path):
    """The trainer of phase 9 goes on into phase 12: a mercy pass and the
    culls inside Trainer.step, the final compression's four files, and
    both render paths on the loaded quantised_half model."""
    train_l, f32_l, tr, it = cs.train_main_path(cpu_card, 0, "cpu")
    assert train_l["seg_reduce_packed"] >= cs.TRAIN["steps"]
    assert f32_l["seg_reduce_f32"] >= cs.TRAIN["f32_steps"]
    assert it == cs.TRAIN["steps"] + cs.TRAIN["timed_steps"] + 1 \
        + cs.TRAIN["f32_steps"] + 1
    assert tr.state.pool.active_sh_degree == 3
    launches, next_it = cs.compression_main_path(
        cpu_card, tr, it, str(tmp_path / "run"), "cpu")
    assert next_it > it + 3
    nv = len(tr.cameras)
    # two culls (the paper's thresholds demote next to nothing here) and
    # one pass of statistics for the second pair of thresholds
    assert launches["tile_trans"] == 5 * nv
    # a render per step, per cull pass and view, and per view of the
    # budget check
    assert launches["expand"] == launches["tile_fwd"] \
        == launches["tile_bwd"] + launches["tile_trans"] + nv
    assert tr.stats["n_points_mercied"] >= 0
    assert not (tmp_path / "run").exists()  # the phase removes its files


def test_phase13_and_14_rehearsal(cpu_card, tmp_path, monkeypatch, capsys):
    """Phase 13 on a fresh phase-9 trainer (eager against grouped, the
    overflow redo, the counted launches, the timing turns), then phase 14:
    the checkpoint round trip and the step after it, and the compress and
    metrics CLIs as subprocesses on a model written beside the ring's
    COLMAP text."""
    from reduced3dgs_torch.models.ply_io import save_gaussian_ply

    monkeypatch.setattr(cs, "FUSED", dict(steps=4, group=2,
                                          overflow_budget=1 << 10, rounds=1))
    monkeypatch.setattr(cs, "COMPRESS", ("--pack_xyz", "--prune_frac",
                                         "0.17", "--finetune_iters", "4"))
    monkeypatch.setattr(cs, "profiled", counted)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cams, leaves = cs.train_cameras(cpu_card, 0)
    tr = cs.make_trainer(cs.student_pool(cpu_card, leaves, 0), cams, 0)
    it = cs.fused_main_path(tr, 1, "cpu")
    assert it == 1 + 3 * 2 + 2 * 2
    out = capsys.readouterr().out
    assert "grouped against eager: loss 0.000e+00" in out
    assert out.count("phase 13: ") == 5
    root = str(tmp_path / "run")
    cs.write_colmap_text(os.path.join(root, "source"), cams)
    save_gaussian_ply(os.path.join(root, "model", "point_cloud",
                                   "iteration_7", "point_cloud.ply"),
                      tr.state.pool)
    assert cs.checkpoint_check(tr, it, root, "cpu") == it + 1
    cs.compress_and_metrics(tr, root, 0, "cpu")
    out = capsys.readouterr().out
    assert "state by 0.000e+00" in out and "Fine-tuned 4 iterations" in out
    assert "train_quantised_half/ours_7: PSNR" in out


def test_phase15_rehearsal(cpu_card, monkeypatch, capsys):
    """Phase 15 at 96x64: the kernels at a tile base against their plain
    versions, the strips against the full frame, the sharded trainers at
    world size 1 (gloo here, NCCL on the card), the (1, 2) run as two
    processes, the scaling harness's line and the blocked kNN check (its
    limit lowered so that 3000 points take the blocked search)."""
    from reduced3dgs_torch.ops import knn as tknn

    monkeypatch.setattr(cs, "MULTI", dict(steps=3, knn_points=3000))
    monkeypatch.setattr(cs, "SCALING_ARGS", (
        "--device", "cpu", "--width", "64", "--prims", "256", "--iters",
        "1"))
    monkeypatch.setattr(tknn, "EXACT_LIMIT", 1000)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    launches = cs.multi_device_path(cpu_card, 0, "cpu", backend="gloo",
                                    device="cpu")
    out = capsys.readouterr().out
    assert out.count("phase 15: K2 / K3 / K4 at tile base") == 3
    assert "no instances" in out and "past the height" in out
    assert "the main path's last strip, tile rows 3..4 of 96x64" in out
    assert "as 4 strips of 1 tile rows" in out
    assert "stitched against the full frame bit for bit" in out
    for name in ("replicated", "param_shard"):
        assert f"gloo at world size 1, ShardedTrainer {name}" in out
    assert out.count("one sharded_train_step, param_shard=") == 2
    assert out.count("two gloo ranks on the one card, param_shard=") == 2
    assert "phase 15: scaling_bench {" in out
    assert "blocked search" in out and "neighbour sets equal on" in out
    # the path alone: per view a K1 / K2 / K3 / K6 per strip (4), the two
    # sharded trainers' 2 x 3 steps, K4 on view 1's 4 strips, K5 once per
    # layout of the raw-gradient step (not the full frames or the
    # single-card references)
    nv = cs.RING_VIEWS
    assert launches["tile_trans"] == 4
    assert launches["seg_reduce_packed"] == 4 * nv + 6
    assert launches["seg_reduce_f32"] == 2
    assert launches["expand"] == launches["tile_fwd"] == 4 * nv + 6 + 2


def test_phase16_rehearsal(cpu_card, tmp_path, monkeypatch, capsys):
    """Phase 16 on a model directory like phase 12's (mixed SH degrees,
    baseline and quantised_half PLYs beside the ring's COLMAP text): the
    ring through measure_fps and its loop against the eager frames, the
    bench at a tiny configuration through the bench's own runner (its
    child's measurement in this process, two steps; the bench CLI's child
    process is tests/test_torch_bench.py's), one viewer frame over
    loopback, and the full_eval and generate_results CLIs as
    subprocesses."""
    from reduced3dgs_torch import bench

    monkeypatch.setattr(cs, "profiled", counted)
    monkeypatch.setattr(cs, "BENCH_CONFIG", (
        SMALL["width"], SMALL["height"], SMALL["n"], SMALL["scales"],
        1 << 16, "tiny"))
    monkeypatch.setattr(cs, "bench_line", lambda device, config:
                        bench.result_line(config[-1], bench.child_result(
                            config, device)))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    arrs = cs.make_arrays(SMALL["n"], SMALL["scales"], 0)
    arrs["degrees"] = np.random.default_rng(0).integers(
        0, 4, SMALL["n"]).astype(np.int32)
    cams = cs.ring_cameras(SMALL["width"], SMALL["height"], n_views=3)
    root = str(tmp_path / "run")
    cs.write_model(root, arrs, cams)
    cs.serving_tools_path(cpu_card, root, "cpu")
    out = capsys.readouterr().out
    assert out.count("graphed views bit for bit the eager images") == 4
    assert "variable-SH: measure_fps" in out
    assert "launches per replay {'expand': 3, 'tile_fwd': 3" in out
    assert "over 3 frames (3 views x 1 replays" in out
    assert '"metric": "raster_fwd_bwd_tiny"' in out
    assert "gradients bit for bit the eager step's" in out
    assert "viewer frame through NetworkGUI" in out and "bytes equal" in out
    assert "full_eval --dry_run --custom_scene on phase 12's scene: 3 " \
        "commands" in out
    with open(os.path.join(root, "summary.csv")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 3 and rows[0].endswith(",fps")
