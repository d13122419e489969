"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test decides inside itself (through the `cuda` fixture)
whether a card is present and skips with a reason where there is none.
Run them on a machine with a card with `python -m pytest
tests/test_torch_gpu.py -n 0`.  K1 (binning's slot keys) and the tile
counts (csrc/tile_counts.cu, in shared and in device memory) must be
bit-exact, and binning on the card must give the CPU's BinningOut bit for
bit, with one launch of each a binning; K2 within 5e-3 on every value
and 1e-4 on >= 99.9 % of them: the walks take their exponent as ex2.approx (WALK_EXP2 1, kept by chip_smoke's
rule: the 1080p ring's frames of the ex2 and the expf builds agree to >=
120 dB, and 30 of its 16.6 M pixels are more than 2e-5 from the plain
version, the largest by 1.9e-3), so a sequential walk and the vectorised
plain version may flip one blend at a threshold; also on the
edge cases (frames that are no multiples of 16, ranges of exactly 128 and
256, a limit inside a batch, an empty frame), and bit for bit between two
launches, as K3; K2 / K3 / K4 on a binning whose pads do not fit
(total_padded > B_pad, pad slots inside the walked ranges) without a
fault, repeatable, K2 / K3 within their criteria; the whole
render on the card within atol 2e-5 / rtol 1e-4 of the CPU render.  K3
holds to the same criterion relative to each gradient row's max, with
exact zeros outside the walked ranges, written as slot-major records;
K5 / K6 to the float64 segment sums within 2e-5 relative plus 1e-5 of the
segment's sum of magnitudes, bit for bit to the plain version on segments
of at most two instances, and bit for bit between two launches, on a
ragged and on a skewed layout;
one train step on the card matches the same step on the CPU (loss to
1e-5 relative, gradients at atol 2e-4 max|g| / rtol 2e-3).  K4 per slot:
every sum within 1.01 (one flipped blend) and >= 99.99 % within atol 1e-3 /
rtol 1e-3, counts differing on <= 0.01 % of the slots by at most 2, exact
zeros outside the walked ranges, two launches bit for bit, also on the
edge cases; the transmittance render on the card
within atol 1e-3 / rtol 1e-3 of the "ref" oracle, touched within 2.
Trainer.step_group on the card (a captured CUDA graph of the train step,
replayed) against eager Trainer.steps on the 512p scene with the
tolerances of tests/test_fused_steps.py (loss rtol 1e-5, parameters rtol
5e-4 / atol 1e-3, num_rendered within 2, budgets equal), one capture for
two groups, K1 / K2 / K3 / K6 once per replayed step; a capacity change
between groups captures anew.  K2 / K3 / K4 at a tile base (the strips of
the multi-device path) against their plain versions at that base, on a
window past the image height and one with no instances, and at base 0
the bits of a launch without it; strips of a view stitched, the full
frame's pixels bit for bit.  The FPS ring and the bench step as replayed
CUDA graphs against their eager runs, bit for bit.  The kNN (csrc/knn.cu)
bit for bit against its plain version (knn_sorted_plain: distances and
rows, ties to the lower row) on chip_smoke.knn_cases, two launches bit
for bit, and knn() taking it above EXACT_LIMIT on a card, for every k
(another k than 3 or 30 is refused).  The preprocess backward
(csrc/preprocess_bwd.cu) against its plain twin at the training cells'
sizes within 1e-4 of each leaf's largest gradient, two launches bit for
bit; its counter once a replay of a captured graph, summing the valid
rows; one train step replayed from a captured graph gives the eager
step's loss, gradients and statistics bit for bit.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_expand_kernel_bit_exact(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import binning

    for _, case in cs.expand_cases():
        kw = {k: torch.as_tensor(v, device=cuda)
              if isinstance(v, np.ndarray) else v for k, v in case.items()}
        before = binning.EXPAND.launches
        got = binning.bin_keys(**kw)
        assert binning.EXPAND.launches == before + 1
        want = binning.bin_keys_plain(**kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_bin_gaussians_on_card_matches_cpu(cuda):
    """The same PreprocessOut binned on the card (K1) and on the CPU (the
    plain version): every BinningOut field bit for bit."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import binning

    prep, _, _ = cs.kernel_inputs(torch.device("cpu"), 200, 136, 20000,
                                  (0.01, 0.05), 1 << 17)
    for budget in (1 << 17, 1 << 13):  # room to spare, truncated
        want = binning.bin_gaussians(prep, 200, 136, budget)
        before = (binning.EXPAND.launches, binning.TILE_COUNTS.launches)
        got = binning.bin_gaussians(type(prep)(*(t.to(cuda) for t in prep)),
                                    200, 136, budget)
        assert (binning.EXPAND.launches,
                binning.TILE_COUNTS.launches) == (before[0] + 1,
                                                  before[1] + 1)
        for field in want._fields:
            assert torch.equal(getattr(got, field).cpu(),
                               getattr(want, field)), field


def test_tile_counts_kernel_bit_exact(cuda):
    """csrc/tile_counts.cu against its plain version, bit for bit, one
    launch a call: chip_smoke.tile_counts_cases with its big cases (2^22
    seeded rows at 1237x822, and a grid past the shared-memory limit, so
    that the device-memory variant runs), each whole and split."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import binning

    paths = set()
    for name, case in cs.tile_counts_cases(big=True):
        kw = {k: torch.as_tensor(v, device=cuda)
              if isinstance(v, np.ndarray) else v for k, v in case.items()}
        before = binning.TILE_COUNTS.launches
        got = binning.tile_counts(**kw)
        assert binning.TILE_COUNTS.launches == before + 1
        want = binning.tile_counts_plain(**kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        paths.add(binning.tile_counts_shared(case["grid_x"], case["grid_y"]))
    assert paths == {True, False}


def test_tile_fwd_kernel_matches_plain(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    _, _, k2in = cs.kernel_inputs(cuda, 200, 136, 20000, (0.01, 0.05), 1 << 17)
    before = tile_render.TILE_FWD.launches
    got = tile_render.tile_fwd(*k2in, 13, 200, 136)
    assert tile_render.TILE_FWD.launches == before + 1
    want = tile_render.tile_fwd_plain(*cs.plain_inputs(k2in), 13, 200, 136)
    torch.cuda.synchronize()
    err, share = cs.compare_k2(got, want)
    assert err <= 5e-3 and share >= 0.999, (err, share)
    # empty tiles and rows 4..7
    assert torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:]))


@pytest.mark.parametrize("fast", [False, True])
def test_tile_bwd_kernel_matches_plain(cuda, fast):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    scene = dict(width=200, height=136, n=20000, scales=(0.01, 0.05))
    before = tile_render.TILE_BWD.launches
    case = cs.k3_case(cuda, scene, 1 << 17, 0, fast)
    # k3_case launches twice: the second must give the same bits
    assert tile_render.TILE_BWD.launches == before + 2
    assert case["err"] < 1e-2
    # one slot-major record per slot, the layout K5 / K6 read
    assert case["dfeat"].shape[0] == 9
    assert case["dfeat"].stride() == (1, tile_render.GRAD_REC)


def test_tile_fwd_edge_cases_and_repeatable(cuda):
    """K2 on frames that are no multiples of 16, ranges of exactly 128 and
    256, a limit that cuts a range mid-batch and an all-empty frame; two
    launches bit for bit (chip_smoke.k2_edge_cases checks all of it)."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    before = tile_render.TILE_FWD.launches
    assert cs.k2_edge_cases(cuda) <= 5e-3
    # per case: the ragged scene's own K2 is not run; two launches each
    assert tile_render.TILE_FWD.launches == before + 2 * 4


def test_tile_bwd_edge_cases_and_repeatable(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    before = tile_render.TILE_BWD.launches
    assert cs.k3_edge_cases(cuda) <= 5e-3
    assert tile_render.TILE_BWD.launches == before + 2 * 4


@pytest.mark.parametrize("fast", [False, True])
def test_tile_walk_two_launches_bit_identical(cuda, fast):
    """K2 and K3 on both feature tables: a second launch on the same
    inputs gives the same bits (no float atomics; the butterfly's adds
    are ordered by lane number)."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    _, _, (src, ranges, limit) = cs.kernel_inputs(
        cuda, 200, 136, 20000, (0.01, 0.05), 1 << 17, fast=fast)
    a = tile_render.tile_fwd(src, ranges, limit, 13, 200, 136)
    b = tile_render.tile_fwd(src, ranges, limit, 13, 200, 136)
    assert torch.equal(a, b)
    g = cs.k3_cotangent(a, 0)
    da = tile_render.tile_bwd(src, ranges, limit, 13, 200, 136, g, a)
    db = tile_render.tile_bwd(src, ranges, limit, 13, 200, 136, g, a)
    torch.cuda.synchronize()
    assert torch.equal(da, db) and float(da.abs().max()) > 0


@pytest.mark.parametrize("fast", [False, True])
def test_tile_walk_pads_past_b_pad_in_bounds(cuda, fast):
    """A binning whose alignment pads do not fit (total_padded > B_pad,
    chip_smoke.overflow_binning): its walked ranges hold pad slots, whose
    rank 2^31 - 1 K2 / K3 / K4 must read as row 0.  The launches finish
    without a fault, two of each give the same bits, and K2 / K3 hold to
    their plain versions on the same table (compare_k2 / compare_k3)."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    b = cs.overflow_binning(cuda)
    src, ranges, limit, gx = tile_render._walk_inputs(b, 200, fast)
    s, e = ranges.long()
    e = torch.minimum(e, limit.long())
    walked = torch.cat([b.gauss_aligned[i:j]
                        for i, j in zip(s.tolist(), e.tolist())])
    assert bool((walked == torch.iinfo(torch.int32).max).any())
    a = tile_render.tile_fwd(src, ranges, limit, gx, 200, 136)
    g = cs.k3_cotangent(a, 0)
    da = tile_render.tile_bwd(src, ranges, limit, gx, 200, 136, g, a)
    ta = tile_render.tile_trans(src, ranges, limit, gx, 200, 136)
    torch.cuda.synchronize()
    assert torch.equal(a, tile_render.tile_fwd(src, ranges, limit, gx, 200,
                                               136))
    assert torch.equal(da, tile_render.tile_bwd(src, ranges, limit, gx, 200,
                                                136, g, a))
    assert torch.equal(ta, tile_render.tile_trans(src, ranges, limit, gx,
                                                  200, 136))
    feat = src.table()
    err, share = cs.compare_k2(
        a, tile_render.tile_fwd_plain(feat, ranges, limit, gx, 200, 136))
    assert err <= 5e-3 and share >= 0.999, (err, share)
    _, rel, share = cs.compare_k3(
        da, tile_render.tile_bwd_plain(feat, ranges, limit, gx, 200, 136, g,
                                       a))
    assert rel <= 5e-3 and share >= 0.999, (rel, share)
    torch.cuda.synchronize()


def test_tile_trans_kernel_matches_plain(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    scene = dict(width=200, height=136, n=20000, scales=(0.01, 0.05))
    before = tile_render.TILE_TRANS.launches
    case = cs.k4_case(cuda, scene, 1 << 17, 0)
    # k4_case launches twice: the second must give the same bits
    assert tile_render.TILE_TRANS.launches == before + 2
    assert case["err"] <= 1.01
    # the dispatcher takes the kernel for a CUDA tensor
    got = tile_render.tile_trans(*case["k4in"])
    assert tile_render.TILE_TRANS.launches == before + 3
    assert got.is_cuda and got.shape[0] == 2


def test_tile_trans_edge_cases_and_repeatable(cuda):
    """K4 on the walk edge cases, two launches bit for bit
    (chip_smoke.k4_edge_cases checks all of it)."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    before = tile_render.TILE_TRANS.launches
    assert cs.k4_edge_cases(cuda) <= 1.01
    assert tile_render.TILE_TRANS.launches == before + 2 * 4


def test_transmittance_render_on_card_matches_ref(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    before = tile_render.TILE_TRANS.launches
    err, d_touch = cs.small_trans_check(cuda)
    assert tile_render.TILE_TRANS.launches == before + 1
    assert err <= 1e-3 and d_touch <= 2


@pytest.mark.parametrize("mode", ["f32", "bf16x2"])
@pytest.mark.parametrize("layout", ["ragged", "skewed"])
def test_seg_reduce_kernels_match_plain(cuda, layout, mode):
    """seg_case checks the kernel against the float64 sums, the plain
    version and a second launch; the skewed layout reaches the warp and
    the block tier (segments of 33-1,024 and of 5,000 slots)."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    kernel = (tile_render.SEG_REDUCE_PACKED if mode == "bf16x2"
              else tile_render.SEG_REDUCE_F32)
    lens = None
    if layout == "skewed":
        lens = cs.skewed_lens(p=20000, n_long=5, long_len=5000, n_mid=100,
                              mid_len=(33, 1024), short_max=3)
    b, rows = cs.segments_binning(cuda, 20000 if lens is not None else 2500,
                                  lens)
    before = kernel.launches
    _, err = cs.seg_case(b, rows, mode, "test")
    assert kernel.launches == before + 2
    assert err < 1e-3
    # the dispatcher takes the kernel for a CUDA tensor, and only K3's
    # record layout
    got = tile_render.segment_reduce_by_src(rows, b, mode)
    assert kernel.launches == before + 3 and got.is_cuda
    with pytest.raises(ValueError, match="slot-major records"):
        tile_render.segment_reduce_by_src(rows.contiguous(), b, mode)


def test_seg_reduce_on_card_matches_cpu(cuda):
    """segment_reduce_by_src on the card against the CPU's plain versions
    on the same inputs: f32 within rtol 2e-5 / atol 2e-4 (another order of
    summation), and bf16x2 no further off (the same rounded values)."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    b_cpu, rows_cpu = cs.segments_binning(torch.device("cpu"), 2500)
    b_gpu, rows_gpu = cs.segments_binning(cuda, 2500)
    for mode in ("f32", "bf16x2"):
        want = tile_render.segment_reduce_by_src(rows_cpu, b_cpu, mode)
        got = tile_render.segment_reduce_by_src(rows_gpu, b_gpu, mode)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-4)


def test_train_step_on_card_matches_cpu(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.config import OptimizationParams
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.train import adam
    from reduced3dgs_torch.train.trainer import TrainState, train_step

    leaves = padded_leaves(cs.make_arrays(3000, (0.02, 0.08), 3))
    cam = Camera.look_at(eye=(0.4, 0.1, -3.4), target=(0, 0, 0), width=120,
                         height=72)
    gt = np.random.default_rng(0).uniform(0, 1, (72, 120, 3)).astype(
        np.float32)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        pool = pool_from_numpy(leaves, dev)
        st = TrainState(pool, adam.init(pool.params), torch.Generator(dev))
        outs.append(train_step(
            st, cam.params(dev), torch.as_tensor(gt, device=dev),
            torch.zeros(3, device=dev), 1, width=120, height=72,
            budget=1 << 15, backend="tile", opt_cfg=OptimizationParams(),
            spatial_lr_scale=1.0, skip_update=True, grad_reduce="f32"))
    (_, m_cpu, g_cpu), (_, m_gpu, g_gpu) = outs
    np.testing.assert_allclose(float(m_gpu["loss"]), float(m_cpu["loss"]),
                               rtol=1e-5)
    for a, b in zip(g_cpu, g_gpu):
        scale = float(a.abs().max())
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                   atol=2e-4 * scale, rtol=2e-3)


@pytest.mark.parametrize("size", ["m360", "tnt"])
def test_preprocess_bwd_kernel_matches_plain(cuda, size):
    """csrc/preprocess_bwd.cu against preprocess_vjp_plain at the training
    cells' sizes (2^22 rows of degree 3, 2^20 of mixed degrees), every
    leaf within chip_smoke.PREP_BWD_GAP of its largest magnitude; two
    launches bit for bit."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import preprocess as tp

    saved, cam, grads = cs.prep_bwd_inputs(cuda, size, 27182818)
    before = tp.PREPROCESS_BWD.launches
    runs = [tp.preprocess_vjp_fused(saved, cam, 1.0, grads)
            for _ in range(2)]
    assert tp.PREPROCESS_BWD.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    gaps = cs.compare_vjp(runs[0], tp.preprocess_vjp_plain(
        saved, cam, 1.0, grads))
    assert max(gaps.values()) <= cs.PREP_BWD_GAP, gaps


def test_preprocess_bwd_counter_in_a_graph(cuda):
    """The backward kernel captured in a CUDA graph: each traced replay
    records the preprocess_bwd counter once, summing the valid rows
    (radii > 0, read on the host), and gives the eager launch's bits."""
    import chip_smoke as cs
    from reduced3dgs_torch import graphs
    from reduced3dgs_torch.ops import preprocess as tp
    from reduced3dgs_torch.utils import profiling

    saved, cam, grads = cs.prep_bwd_inputs(cuda, "tnt", 31415926)
    eager = tp.preprocess_vjp_fused(saved, cam, 1.0, grads)
    profiling.ring(cuda)
    run = graphs.runner(lambda: tp.preprocess_vjp_fused(
        saved, cam, 1.0, grads), cuda)
    profiling.reset()
    with profiling.enable():
        run.replay()
        run.replay()
        snap = profiling.snapshot()
    profiling.reset()
    valid = int((saved.radii > 0).sum())
    assert snap["counters"]["preprocess_bwd"] == {
        "sum": 2 * valid, "max": valid, "count": 2}
    assert all(torch.equal(a, b) for a, b in zip(run.out, eager))


def test_train_step_graph_matches_eager_bit_for_bit(cuda):
    """One train_step (skip_update: its gradients) eagerly and replayed
    from a captured CUDA graph: the loss, the five leaves' gradients and
    the densification statistics (the screen offset's gradient) bit for
    bit; the eager step launches the preprocess backward kernel once and
    the no-grad forward kernel never."""
    import chip_smoke as cs
    from reduced3dgs_torch import graphs
    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.config import OptimizationParams
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.ops import preprocess as tp
    from reduced3dgs_torch.train import adam
    from reduced3dgs_torch.train.trainer import TrainState, train_step

    pool = pool_from_numpy(padded_leaves(cs.make_arrays(
        3000, (0.02, 0.08), 3)), cuda)
    st = TrainState(pool, adam.init(pool.params), torch.Generator(cuda))
    cam = Camera.look_at(eye=(0.4, 0.1, -3.4), target=(0, 0, 0), width=120,
                         height=72).params(cuda)
    gt = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 1, (72, 120, 3)).astype(np.float32), device=cuda)

    def step():
        return train_step(
            st, cam, gt, torch.zeros(3, device=cuda), 1, width=120,
            height=72, budget=1 << 15, backend="tile",
            opt_cfg=OptimizationParams(), spatial_lr_scale=1.0,
            skip_update=True, grad_reduce="bf16x2")

    fwd, bwd = tp.PREPROCESS_FWD.launches, tp.PREPROCESS_BWD.launches
    s_eager, m_eager, g_eager = step()
    assert tp.PREPROCESS_BWD.launches == bwd + 1
    assert tp.PREPROCESS_FWD.launches == fwd
    run = graphs.runner(step, cuda)
    run.replay()
    s_graph, m_graph, g_graph = run.out
    assert torch.equal(m_graph["loss"], m_eager["loss"])
    assert all(torch.equal(a, b) for a, b in zip(g_eager, g_graph))
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(s_eager.pool, k), getattr(s_graph.pool, k))


def test_render_on_card_matches_cpu(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.renderer import render

    arrs = cs.bench_scene(3000, (0.02, 0.08), 2)
    cam = Camera.look_at(eye=(0.5, 0.2, -3.4), target=(0, 0, 0), width=120,
                         height=72)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        a = [torch.as_tensor(x, device=dev) for x in arrs]
        outs.append(render(*a, cam.params(dev),
                           torch.tensor([0.1, 0.2, 0.3], device=dev),
                           width=120, height=72, instance_budget=1 << 15))
    cpu, gpu = outs
    np.testing.assert_allclose(gpu.color.cpu().numpy(), cpu.color.numpy(),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(gpu.final_t.cpu().numpy(),
                               cpu.final_t.numpy(), atol=2e-5, rtol=1e-4)


def _graph_trainers(cuda, count=2, seed=0):
    """`count` identical Trainers on bench.py's 512p scene: ground truth
    rendered at four ring views, a perturbed copy to train (chip_smoke's
    phase 9 set-up at 512p), a budget that fits every view."""
    import chip_smoke as cs
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.render import PoolView, render_view

    s = cs.K2_SCENE
    leaves = padded_leaves(cs.make_arrays(s["n"], s["scales"], seed),
                           capacity=s["n"])
    cams = cs.ring_cameras(s["width"], s["height"], n_views=4)
    pv = PoolView(pool_from_numpy(leaves, cuda))
    bg = torch.zeros(3, device=cuda)
    for cam in cams:
        out, _ = render_view(pv, cam, bg, s["budget"])
        cam.image = out.color.clamp(0, 1).cpu().numpy()
    trainers = []
    for _ in range(count):
        tr = cs.make_trainer(cs.student_pool(cuda, leaves, seed), cams, seed)
        tr.initial_budget = s["budget"]
        trainers.append(tr)
    return trainers


def _assert_group_matches(eager, graphed, m_eager, m_graphed):
    """chip_smoke phase 13's tolerances (tests/test_fused_steps.py)."""
    assert len(m_eager) == len(m_graphed)
    for a, b in zip(m_eager, m_graphed):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=1e-5)
        assert abs(int(a["num_rendered"]) - int(b["num_rendered"])) <= 2
    for a, b in zip(eager.state.pool.params, graphed.state.pool.params):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   rtol=5e-4, atol=1e-3)
    assert eager.budgets == graphed.budgets
    assert list(eager.state.opt.step) == list(graphed.state.opt.step)


def test_step_group_graph_matches_eager_steps(cuda):
    """Two groups of four replays of one captured step against eight
    eager steps: one capture, K1, K2, K3 and K6 once per replayed step."""
    eager, graphed = _graph_trainers(cuda)
    m_eager = [eager.step(i) for i in range(1, 9)]
    m_graphed = graphed.step_group(range(1, 5))
    m_graphed += graphed.step_group(range(5, 9))
    _assert_group_matches(eager, graphed, m_eager, m_graphed)
    assert graphed.graph_captures == 1
    g = graphed.graph_launches
    assert g["expand"] == g["tile_fwd"] == g["tile_bwd"] \
        == g["seg_reduce_packed"] == 8 and g["seg_reduce_f32"] == 0


def test_step_group_recaptures_on_capacity_growth(cuda):
    """Pool growth between two groups changes the graph's key: the
    second group captures anew, on the grown buffers, and still matches
    the eager steps on the same grown pool."""
    from reduced3dgs_torch.models.gaussians import round_capacity
    from reduced3dgs_torch.train import trainer as T

    eager, graphed = _graph_trainers(cuda)
    m_eager = [eager.step(i) for i in range(1, 5)]
    m_graphed = graphed.step_group(range(1, 5))
    for tr in (eager, graphed):
        pool, opt, _ = tr.rows.grow(tr.state.pool, tr.state.opt, None,
                                    round_capacity(tr.state.pool.capacity
                                                   * 2))
        tr.state = T.TrainState(pool, opt, tr.state.generator)
    m_eager += [eager.step(i) for i in range(5, 9)]
    m_graphed += graphed.step_group(range(5, 9))
    assert graphed.state.pool.capacity == eager.state.pool.capacity \
        == 2 * (1 << 17)
    _assert_group_matches(eager, graphed, m_eager, m_graphed)
    assert graphed.graph_captures == 2
    assert len(graphed._graphs) == 2


def test_walk_kernels_at_a_tile_base_match_plain(cuda):
    """K2, K3 and K4 on windows of tile rows at a tile base (one past the
    image height, one with no instances, the main path's last 1080p
    strip) against their plain versions at that base, two launches bit
    for bit (chip_smoke.strip_kernel_checks checks all of it)."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    before = [k.launches for k in (tile_render.TILE_FWD,
                                   tile_render.TILE_BWD,
                                   tile_render.TILE_TRANS)]
    cs.strip_kernel_checks(cuda)
    after = [k.launches for k in (tile_render.TILE_FWD,
                                  tile_render.TILE_BWD,
                                  tile_render.TILE_TRANS)]
    assert [a - b for a, b in zip(after, before)] == [6, 6, 6]


def test_walk_kernels_at_base_zero_unchanged(cuda):
    """base = 0 is the whole frame: the keyword gives the bits of a launch
    without it, K2, K3 and K4."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render as ttr

    _, _, k2in = cs.kernel_inputs(cuda, 200, 136, 20000, (0.01, 0.05),
                                  1 << 17)
    a = ttr.tile_fwd(*k2in, 13, 200, 136)
    assert torch.equal(a, ttr.tile_fwd(*k2in, 13, 200, 136, base=0))
    g = cs.k3_cotangent(a, 0)
    assert torch.equal(ttr.tile_bwd(*k2in, 13, 200, 136, g, a),
                       ttr.tile_bwd(*k2in, 13, 200, 136, g, a, base=0))
    assert torch.equal(ttr.tile_trans(*k2in, 13, 200, 136),
                       ttr.tile_trans(*k2in, 13, 200, 136, base=0))


def test_strips_stitch_to_the_full_frame_on_card(cuda):
    """A 200x136 view as strips of 3 + 3 + 3 tile rows on the card (their
    own binning, K1 / K2): stitched, the full frame's pixels bit for bit."""
    import chip_smoke as cs
    from reduced3dgs_torch.ops import binning, tile_render

    prep, full_b, _ = cs.kernel_inputs(cuda, 200, 136, 20000, (0.01, 0.05),
                                       1 << 17)
    bg = torch.tensor([0.2, 0.1, 0.4], device=cuda)
    with torch.no_grad():
        full = tile_render.tile_render(prep, full_b, bg, 200, 136)
        parts = [tile_render.tile_render(
            prep, binning.bin_gaussians(prep, 200, 136, 1 << 17,
                                        tile_rows=(r0, 3)),
            bg, 200, 136, tile_rows=(r0, 3)) for r0 in (0, 3, 6)]
    color = torch.cat([p[0] for p in parts])
    t_fin = torch.cat([p[1] for p in parts])
    assert torch.equal(color[:136], full[0])
    assert torch.equal(t_fin[:136], full[1])
    assert bool((t_fin[136:] == 1).all())


def test_graphed_ring_and_bench_step_match_eager(cuda):
    """The FPS ring captured as one CUDA graph (render.py fps_ring) gives
    every view's eager image bit for bit, dense and variable-SH, with one
    K1 and one K2 per frame; the bench step replayed gives the eager
    step's loss and gradients bit for bit."""
    import chip_smoke as cs
    from reduced3dgs_torch import bench
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )
    from reduced3dgs_torch.render import (
        PoolView, fps_ring, measure_fps, render_once,
    )

    arrs = cs.make_arrays(1 << 14, (0.01, 0.05), 0)
    arrs["degrees"] = np.random.default_rng(0).integers(
        0, 4, 1 << 14).astype(np.int32)
    pool = pool_from_numpy(padded_leaves(arrs), cuda)
    cams = cs.ring_cameras(320, 240, n_views=3)
    bg = torch.zeros(3, device=cuda)
    for variable_sh in (False, True):
        pv = PoolView(pool, variable_sh=variable_sh)
        res = measure_fps(pv, cams, bg)
        assert res["frames"] == 33 and res["fps"] > 0
        assert res["launches"]["expand"] == res["launches"]["tile_fwd"] == 3
        cps = [c.params(cuda) for c in cams]
        ring = fps_ring(pv, cps, bg, res["budget"])
        ring.replay()
        for cp, got in zip(cps, ring.out):
            want = render_once(pv, cp, bg, res["budget"])
            assert torch.equal(got.color, want.color)
            assert torch.equal(got.final_t, want.final_t)
    fb = bench.FwdBwd(320, 240, 1 << 14, 0.01, 0.05, 1 << 17, cuda)
    loss, nr, grads = fb.step()
    run = fb.runner()
    run.replay()
    assert torch.equal(run.out[0], loss) and int(run.out[1]) == int(nr)
    assert all(torch.equal(a, b) for a, b in zip(run.out[2], grads))
    assert run.launches["tile_bwd"] == run.launches["seg_reduce_packed"] == 1


def test_knn_kernel_matches_plain(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import knn as tknn

    assert cs.knn_checks(cuda, say=lambda *a: None) == len(cs.knn_cases())
    rng = np.random.default_rng(3)
    pts = np.full((tknn.EXACT_LIMIT + 4000, 3), np.inf, np.float32)
    pts[:tknn.EXACT_LIMIT + 3000] = rng.normal(0, 1, (tknn.EXACT_LIMIT
                                                       + 3000, 3))
    t = torch.as_tensor(pts, device=cuda)
    before = tknn.KNN.launches
    d2, idx = tknn.knn(t, 30)
    assert tknn.KNN.launches == before + 1
    real = tknn.EXACT_LIMIT + 3000
    want_d2, want_i = tknn.knn_sorted_plain(t[:real], 30, rows=256)
    assert torch.equal(d2[:real], want_d2) and torch.equal(idx[:real],
                                                          want_i)
    assert bool(torch.isinf(d2[real:]).all())


def test_knn_kernel_refuses_another_k(cuda):
    """Above EXACT_LIMIT a card has one search: csrc/knn.cu, built for
    k = 3 and 30; another k raises rather than falling back."""
    from reduced3dgs_torch.ops import knn as tknn

    rng = np.random.default_rng(5)
    t = torch.as_tensor(rng.normal(0, 1, (tknn.EXACT_LIMIT + 100, 3)).astype(
        np.float32), device=cuda)
    before = tknn.KNN.launches
    with pytest.raises(RuntimeError, match="knn_launch"):
        tknn.knn(t, 5)
    assert tknn.KNN.launches == before
    d2, _ = tknn.knn(t, 3)
    assert tknn.KNN.launches == before + 1 and d2.shape == (t.shape[0], 3)
