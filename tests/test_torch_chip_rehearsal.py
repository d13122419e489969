"""chip_smoke.py's kernel checks of phases 2, 3 and 5, the WALK_EXP2
comparison of phases 4 and 10, and its training, compression, fused-step,
offline and multi-device phases (7-15) rehearsed on the CPU at a tiny
size.  The CUDA
wrappers are replaced by their plain versions, which here count launches
as the kernels do; CUDA events by a host clock; the profiled step is
skipped, and the profiled group of phase 13 counts the plain versions'
launches instead of kernel names (step_group runs its loop here, not a
graph).  What this checks is the phases' control flow,
shapes and checks, not the kernels (tests/test_torch_gpu.py does that on
a card)."""

import os
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import tile_render as ttr
from reduced3dgs_torch.train import trainer as ttrainer

SMALL = dict(width=96, height=64, n=3000, scales=(0.02, 0.08))


class _HostEvent:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _counting(fn, kernel):
    def run(*a, **kw):
        kernel.launches += 1
        return fn(*a, **kw)
    return run


@pytest.fixture
def cpu_card(monkeypatch):
    monkeypatch.setattr(cs, "MAIN", SMALL)
    monkeypatch.setattr(cs, "K2_SCENE", dict(SMALL, budget=1 << 15))
    monkeypatch.setattr(cs, "TRAIN", dict(cs.TRAIN, grad_threshold=1e-6))
    monkeypatch.setattr(cs, "BENCH_BUDGET", 1 << 16)
    monkeypatch.setattr(cs, "SKEWED", dict(
        p=4000, n_long=2, long_len=3000, n_mid=20, mid_len=(33, 300),
        short_max=3))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(cs, "profile_step", lambda *a: None)
    monkeypatch.setattr(ttr, "_tile_fwd_cuda", ttr.tile_fwd_plain)
    monkeypatch.setattr(ttr, "_tile_bwd_cuda", ttr.tile_bwd_plain)
    monkeypatch.setattr(ttr, "_seg_reduce_cuda", ttr.seg_reduce_plain)
    monkeypatch.setattr(ttr, "_tile_trans_cuda", ttr.tile_trans_plain)
    monkeypatch.setattr(tbin, "_bin_keys_cuda", tbin.bin_keys_plain)
    monkeypatch.setattr(ttr, "tile_trans_plain", _counting(
        ttr.tile_trans_plain, ttr.TILE_TRANS))
    monkeypatch.setattr(tbin, "bin_keys_plain", _counting(
        tbin.bin_keys_plain, tbin.EXPAND))
    monkeypatch.setattr(ttr, "tile_fwd_plain", _counting(
        ttr.tile_fwd_plain, ttr.TILE_FWD))
    monkeypatch.setattr(ttr, "tile_bwd_plain", _counting(
        ttr.tile_bwd_plain, ttr.TILE_BWD))
    plain_seg = ttr.seg_reduce_plain

    def seg(rows, order, bounds, packed):
        k = ttr.SEG_REDUCE_PACKED if packed else ttr.SEG_REDUCE_F32
        k.launches += 1
        return plain_seg(rows, order, bounds, packed)

    monkeypatch.setattr(ttr, "seg_reduce_plain", seg)
    return torch.device("cpu")


def test_phase3_and_5_walk_checks(cpu_card, capsys):
    """The edge cases of phases 3 and 7 and K2's report with its lane
    utilisation lines."""
    assert cs.k2_edge_cases(cpu_card) == 0.0
    assert cs.k3_edge_cases(cpu_card) == 0.0
    assert cs.k4_edge_cases(cpu_card) == 0.0
    names = [c[0] for c in cs.walk_edge_cases(cpu_card)]
    assert len(names) == 4 and "all-empty frame" in names
    feat, ranges, limit = cs.walk_edge_cases(cpu_card)[2][1]
    assert int(limit) % 64 and ranges[0, 3] < int(limit) < ranges[1, 3]
    assert (ranges[1] - ranges[0]).tolist() == [128, 256, 0, 384, 128, 256]
    _, _, k2in = cs.kernel_inputs(cpu_card, SMALL["width"], SMALL["height"],
                                  SMALL["n"], SMALL["scales"], 1 << 15)
    row = cs._report_k2(k2in, SMALL["width"], SMALL["height"], 7, ttr)
    assert row["launches"] == 7 and row["bound_by"] == "operations"
    assert row["max_abs_err"] == 0.0 and row["library_ms"] is None
    out = capsys.readouterr().out
    assert out.count("lane utilisation walked / (") == 2
    assert "two launches bit-identical" in out


def test_phase2_and_5_k1_checks(cpu_card, capsys):
    """K1 on its edge cases, then at a binned scene's inputs: keys and the
    whole BinningOut against the plain version's, times and the bound."""
    cs.k1_edge_cases(cpu_card)
    prep, _, _ = cs.kernel_inputs(cpu_card, SMALL["width"], SMALL["height"],
                                  SMALL["n"], SMALL["scales"], 1 << 15)
    before = tbin.EXPAND.launches
    row = cs._report_k1(prep, SMALL["width"], SMALL["height"], 1 << 15, 9,
                        tbin)
    # the binning call whose inputs are captured, and the one that runs
    # the plain version for the BinningOut comparison
    assert tbin.EXPAND.launches > before
    assert row["launches"] == 9 and row["max_abs_err"] == 0.0
    assert row["bound_by"] == "bytes" and row["library_ms"] > 0
    assert row["bound_ms"] > 0 and row["plain_ms"] > 0
    out = capsys.readouterr().out
    assert out.count("phase 2: K1 ") == len(cs.expand_cases())
    assert "BinningOut bit-identical" in out


def test_phase4_and_10_exp2_comparison(cpu_card, capsys):
    """The ring through K2 and its expf build (the same plain version
    here), K4's builds per primitive, and the verdict line."""
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.render import PoolView

    arrs = cs.make_arrays(SMALL["n"], SMALL["scales"], 0)
    pv = PoolView(pool_from_numpy(
        padded_leaves(arrs, capacity=SMALL["n"]), cpu_card))
    views = cs.ring_cameras(SMALL["width"], SMALL["height"], n_views=2)
    expf = cs.expf_kernels()
    assert all(k.defines == cs.EXPF for k in expf.values())
    frames = cs.exp2_frames(pv, views, 1 << 15, expf["tile_fwd"])
    assert frames[0] >= 100.0 and frames[1] == {"ex2": 0, "expf": 0}
    assert frames[3] == 2 * SMALL["width"] * SMALL["height"]
    case = cs.k4_case(cpu_card, cs.MAIN, 1 << 15, 0)
    num_p, touched, off, bits = cs.exp2_trans(case, expf["tile_trans"])
    assert num_p == SMALL["n"] and touched == off == bits == 0
    assert cs.exp2_verdict(frames, (num_p, touched, off, bits), "cpu")
    assert "rule (>= 60 dB" in capsys.readouterr().out
    assert ttr.TILE_FWD.defines == ttr.TILE_TRANS.defines == ()


def test_lane_text():
    text = cs.lane_text(dict(walked=640, blended=96, warp_walked=40,
                             warp_blended=12, staged=8))
    assert "warp_walked 40, warp_blended 12, staged 8" in text
    assert "50.00 %" in text and "25.00 %" in text


def test_phase7_kernel_cases(cpu_card, capsys):
    case = cs.k3_case(cpu_card, cs.MAIN, 1 << 15, 0, fast=True)
    assert case["dfeat"].shape[0] == 9 and case["err"] == 0.0
    walked = cs.walked_slots(case["k3in"][1], case["k3in"][2],
                             case["dfeat"].shape[1])
    assert 0 < int(walked.sum()) < walked.numel()
    cs.ragged_seg_cases(cpu_card)
    cs.skewed_seg_case(cpu_card)
    for mode in ("f32", "bf16x2"):
        inputs, err = cs.seg_case(case["binning"], case["dfeat"], mode, "x")
        assert err == 0.0
        row = cs.report_seg(inputs, err, mode, 3)
        assert row["launches"] == 3 and row["bound_by"] == "bytes"
        assert row["library_ms"] > 0 and row["library_same_inputs_ms"] > 0
    row = cs.report_k3(case, 5)
    # at this budget most tiles are empty: their pixel rows outweigh the
    # walk's arithmetic
    assert row["bound_by"] == "bytes" and row["plain_ms"] > 0
    assert row["bound_ms"] > 0
    assert "on the first kernels' operation counts" in capsys.readouterr().out


def test_phase8_and_9_rehearsal(cpu_card):
    worst_ref, worst_16 = cs.small_grad_check(cpu_card)
    assert worst_ref < 2e-3 and worst_16 < 2e-2
    pps, ms, nr = cs.fwd_bwd_rate(cpu_card, 0)
    assert pps > 0 and 0 < nr <= cs.BENCH_BUDGET


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


def test_phase10_and_11_rehearsal(cpu_card, capsys):
    case = cs.k4_case(cpu_card, cs.MAIN, 1 << 15, 0)
    assert case["err"] == 0.0 and case["k4in"][0].shape[0] == 9
    assert torch.equal(case["out"], ttr.tile_trans_plain(*case["k4in"]))
    row = cs.report_k4(case, 16)
    assert row["name"] == "tile_trans" and row["launches"] == 16
    assert row["bound_by"] == "operations" and row["library_ms"] is None
    assert row["plain_ms"] > 0 and row["bound_ms"] > 0
    err, d_touch = cs.small_trans_check(cpu_card)
    assert err <= 1e-3 and d_touch <= 2
    out = capsys.readouterr().out
    assert "two launches bit-identical" in out
    assert out.count("lane utilisation walked / (") == 2


def test_student_is_a_perturbed_copy():
    cams = cs.ring_cameras(32, 24, n_views=2)
    assert len(cams) == 2
    leaves = cs.make_arrays(64, (0.01, 0.02), 1)
    from reduced3dgs_torch.models.gaussians import padded_leaves

    pl = padded_leaves(leaves, capacity=64)
    pool = cs.student_pool("cpu", pl, 0)
    dc = pool.features()[:, 0].numpy()
    d = dc - pl["features_dc"][:, 0]
    assert 0.2 < d.std() < 0.4
    np.testing.assert_array_equal(pool.params.xyz.numpy(), pl["xyz"])
    assert ttrainer.TRAIN_STAGES[-1] == "adam"


def _counted(fn):
    """chip_smoke.profiled on the CPU: the kernels' counts are the plain
    versions' launches during fn(); no kernel time is known."""
    kernels = {"expand": tbin.EXPAND, "tile_fwd": ttr.TILE_FWD,
               "tile_bwd": ttr.TILE_BWD,
               "seg_reduce_packed": ttr.SEG_REDUCE_PACKED,
               "seg_reduce_f32": ttr.SEG_REDUCE_F32}
    before = {n: kern.launches for n, kern in kernels.items()}
    fn()
    return ({n: kern.launches - before[n] for n, kern in kernels.items()},
            0.0, 1.0, 0, 0)


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
    monkeypatch.setattr(cs, "profiled", _counted)
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
