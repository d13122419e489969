"""chip_smoke.py's kernel checks of phases 2, 3 and 5, the WALK_EXP2
comparison of phases 4 and 10, and its K4 and transmittance phases (10-11)
rehearsed on the CPU at a tiny size (tests/chip_rehearsal.py: the CUDA
wrappers replaced by their plain versions, which count launches here as
the kernels do).  Phases 7-9 are rehearsed in
test_torch_chip_rehearsal_train.py, phases 9 / 12-16 in
test_torch_chip_rehearsal_late.py: three files, so that pytest-xdist
spreads them over three workers."""

import torch

import chip_smoke as cs
from chip_rehearsal import SMALL, cpu_card  # noqa: F401 (a fixture)
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import tile_render as ttr


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
