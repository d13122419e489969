"""chip_smoke.py's training phases rehearsed on the CPU at a tiny size
(tests/chip_rehearsal.py): the training kernels' cases of phase 7, the
gradient check of phase 8 and phase 9's fwd+bwd rate (through
reduced3dgs_torch.bench) and student scene."""

import numpy as np

import chip_smoke as cs
from chip_rehearsal import cpu_card  # noqa: F401 (a fixture)
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.utils import profiling


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
    pps, ms, nr = cs.fwd_bwd_rate(cpu_card)
    assert pps > 0 and 0 < nr <= cs.BENCH_BUDGET


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
    assert profiling.TRAIN_STAGES[-2:] == ("adam", "store")
