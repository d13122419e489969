"""The viewer's frame entry (reduced3dgs_torch/render.py FrameServer) on
the CPU, where its runner is a loop of render_once: its frames equal
render_view's eager ones bit for bit, a pose over the budget is redone
up the ladder and counted, and its spans and the pads_spilled counter
reach profiling.snapshot().

The scene is sparse (1,000 small primitives at 160x128, 80 tiles): each
view needs ~8,900 alignment pads against a slack pool of 8,192 slots, so
every frame lays pads past the pool.  This file imports no JAX.
"""

import pytest
import torch

import chip_smoke as cs
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.models.gaussians import padded_leaves, pool_from_numpy
from reduced3dgs_torch.render import FrameServer, PoolView, render_view
from reduced3dgs_torch.train.trainer import camera_vector
from reduced3dgs_torch.utils import profiling

W, H, N = 160, 128, 1000
BUDGET = 4096


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def pv():
    arrs = cs.make_arrays(N, (0.004, 0.01), 0)
    return PoolView(pool_from_numpy(padded_leaves(arrs), "cpu"))


@pytest.fixture(scope="module")
def cams():
    return cs.ring_cameras(W, H, 4)


def test_frames_equal_render_views(pv, cams):
    bg = torch.zeros(3)
    server = FrameServer(pv, W, H, bg, 1024)
    assert server.settle(cams[:2]) == 1536
    for cam in cams + cams[:1]:
        with profiling.enable():
            got = server.frame(camera_vector(cam)).color.clone()
        want, _ = render_view(pv, cam, bg, server.budget)
        assert torch.equal(got, want.color)
    assert "budget_redos" not in profiling.snapshot()["counters"]
    assert server.budget == 1536


def test_a_pose_over_the_budget_is_redone_once(pv, cams):
    bg = torch.zeros(3)
    server = FrameServer(pv, W, H, bg, 1024)
    server.settle(cams[:1])
    server.budget = 256  # a rung the next pose cannot fit
    server._capture()
    with profiling.enable():
        out = server.frame(camera_vector(cams[2]))
        snap = profiling.snapshot()
    assert server.budget == 1536
    assert snap["counters"]["budget_redos"]["sum"] == 1
    assert snap["spans"]["r3dgs.serve.recapture"]["calls"] == 1
    want, _ = render_view(pv, cams[2], bg, BUDGET)
    assert torch.equal(out.color, want.color)
    assert int(out.num_rendered) == int(want.num_rendered) <= server.budget


def test_settling_counts_its_redos(pv, cams):
    """settle_budget redoes through renderer.fit, which counts the climb
    from 1024 to 1536 as one budget redo."""
    server = FrameServer(pv, W, H, torch.zeros(3), 1024)
    with profiling.enable():
        assert server.settle(cams[:2]) == 1536
        snap = profiling.snapshot()
    assert snap["counters"]["budget_redos"]["sum"] == 1
    assert snap["spans"]["r3dgs.render.settle_budget"]["calls"] == 1


def test_spans_and_pads_spilled_reach_the_snapshot(pv, cams):
    bg = torch.zeros(3)
    server = FrameServer(pv, W, H, bg, BUDGET)
    with profiling.enable():
        for cam in cams:
            server.frame(camera_vector(cam))
        snap = profiling.snapshot()
    spans = snap["spans"]
    assert spans["r3dgs.serve.frame"]["calls"] == len(cams)
    assert spans["r3dgs.serve.replay"]["calls"] == len(cams)
    assert spans["r3dgs.serve.read"]["calls"] == len(cams)
    assert spans["r3dgs.serve.recapture"]["calls"] == 1  # the first frame
    counters = snap["counters"]
    assert snap["stages"]["binning"]["count"] == len(cams) + 1  # + capture
    renders = counters["num_rendered"]["count"]
    spilled = counters["pads_spilled"]
    assert spilled["count"] == renders and spilled["max"] > 0
    # each render's spill is its pad need past the pool
    pool = counters["pad_need_permille"]
    assert pool["max"] > 1000
    assert counters["pad_spill_permille"]["count"] == renders
    assert 0 < counters["pad_spill_permille"]["max"] == pool["max"] - 1000


def test_the_serve_cell_at_a_small_size():
    """The benchmark's m360_full.serve cell (splatbench/generators/
    serve.py) traced on the CPU at 160x128 and 8,000 primitives of its
    configuration, where the first pose of the seed's path (the window's
    first frame) lays pads past the slack pool: correct, and its
    per-layer metrics read, the two of this cell among them."""
    from splatbench import run
    from splatbench.tests import tiny

    bench = run.Bench()
    cell = bench.cell("m360_full.serve")
    cfg = tiny.config("m360_full", width=160, height=128, primitives=8000,
                      capacity=8192)
    cfg["assumed"]["scale_base"] = bench.config(cell)["assumed"][
        "scale_base"]
    # the window's first frame is the one kept and counted, so that a
    # loaded machine's slow frames cannot leave it out
    traffic = tiny.traffic("serve", check_from=1, check_frames=1,
                           count_samples=1)
    out = run.measure(bench, cell, 7, 1.0, True, torch.device("cpu"),
                      cfg=cfg, traffic=traffic)
    line, _ = run.result_line(bench, cell, out, bench.limits(cell), True,
                              1.0, {"platform": "cpu"})
    assert line["correct"] is True, line["checks"]
    metrics = line["metrics"]
    assert metrics["pad_spill_permille.serve"]["value"] > 0
    assert metrics["serve_host_ms.serve"]["value"] > 0
    assert metrics["binning_ms.view"]["value"] > 0
    assert out.record["kind"] == "view" and out.attempted >= 1
