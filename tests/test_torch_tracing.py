"""The port's tracing (reduced3dgs_torch/utils/profiling.py): the stage
clock, the host spans and the counters, and the benchmark's readers of
them (splatbench/program_trace.py).

On the CPU the stage clock stamps on the host, in the order the stage
boundaries run, so the order and the tiling are exact there.  Off, the
instruments record nothing and change no bit of a train step or a frame;
on (an enable() or a recording torch.profiler) every stage of
profiling.TRAIN_STAGES / VIEW_STAGES is timed once per step or frame,
and the device counters equal the binnings' own values read on the host
(chip_smoke.binning_spy / check_counters).
The cases marked `gpu` (run on a card: `python -m pytest
tests/test_torch_tracing.py --noconftest -o addopts= -p no:cacheprovider`)
hold the device ring: a replayed StepGraph and a graphs.runner frame
stamp only while tracing is on, the tile counts' tile_counts_rows once a
replayed frame, and a full ring counts what it drops.  A compression
iteration (dead-prune, mercy, the SH-band cull) times mercy's parts and
each transmittance render's render and statistics as stages, nests
their spans in its surgery spans and counts mercy's and the cull's
rows.
This file imports no JAX.
"""

import dataclasses
import json

import pytest
import torch

import chip_smoke as cs
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models.gaussians import padded_leaves, pool_from_numpy
from reduced3dgs_torch.render import PoolView, render_once, render_view
from reduced3dgs_torch.train import trainer as T
from reduced3dgs_torch.utils import profiling

SCENE = dict(width=64, height=48, n=400, scales=(0.03, 0.1))
BUDGET = 1 << 12
PRUNE_AT = 10  # the trainer's one surgery iteration (a dead-prune)
ID = {n: i for i, n in enumerate(profiling.STAGES)}


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _trainer(device, seed=0, budget=BUDGET):
    cams, leaves = cs.train_cameras(device, seed, n_views=3, scene=SCENE)
    cfg = dataclasses.replace(
        OptimizationParams(), iterations=100, densify_from_iter=1,
        densify_until_iter=PRUNE_AT, densification_interval=PRUNE_AT,
        opacity_reset_interval=10_000, prune_dead_points=True)
    tr = T.Trainer(cs.student_pool(device, leaves, seed), cfg, cams,
                   spatial_lr_scale=3.0, background=torch.zeros(3),
                   initial_budget=budget, seed=seed, grad_reduce="bf16x2")
    tr.extent = 3.0
    return tr


def _compressing_trainer(device="cpu", seed=0):
    """A trainer whose iteration PRUNE_AT is full_final's compression
    iteration: the dead-prune, mercy and the SH-band cull."""
    tr = _trainer(device, seed)
    tr.opt_cfg = dataclasses.replace(
        tr.opt_cfg, iterations=10_000, mercy_points=True, mercy_interval=1,
        mercy_type="redundancy_opacity_opacity", std_threshold=0.04,
        cdist_threshold=6.0)
    tr.fine_tune_start = tr.opt_cfg.iterations - T.FINE_TUNE_ITERS
    tr.cull_sh_iterations = (PRUNE_AT,)
    assert tr.events_at(PRUNE_AT) == ("prune_dead", "mercy", "cull")
    return tr


def _pool_view(device, variable_sh):
    arrs = cs.make_arrays(SCENE["n"], SCENE["scales"], 0)
    arrs["degrees"] = (torch.arange(SCENE["n"]) % 4).int().numpy()
    return PoolView(pool_from_numpy(padded_leaves(arrs), device),
                    variable_sh=variable_sh)


def _run(tr):
    """Two eager steps, a group of three and the dead-prune step."""
    ms = [tr.step(1), tr.step(2)]
    ms += tr.step_group(range(3, 6))
    ms.append(tr.step(PRUNE_AT))
    return ms


def _ids(entries):
    return [i for i, _ in entries if i < len(profiling.STAGES)]


def test_trainer_iterations_are_as_planned():
    tr = _trainer("cpu")
    assert all(tr.fusible(i) for i in range(1, PRUNE_AT))
    assert tr._events(PRUNE_AT) == (False, False, True, False)


def test_tracing_off_records_nothing_and_changes_no_bit():
    off, on = _trainer("cpu"), _trainer("cpu")
    m_off = _run(off)
    snap = profiling.snapshot()
    assert snap["stages"] == snap["spans"] == {}
    assert snap["counters"] == {} and snap["stages_open"] == 0
    with profiling.enable():
        m_on = _run(on)
    assert profiling.snapshot()["stages"]
    for a, b in zip(m_off, m_on):
        assert {k: float(v) for k, v in a.items()} == \
            {k: float(v) for k, v in b.items()}
    for a, b in zip(T.carried(off.state), T.carried(on.state)):
        assert torch.equal(a, b)
    for variable_sh in (False, True):
        pv = _pool_view("cpu", variable_sh)
        cp = off.cameras[0].params("cpu")
        want = render_once(pv, cp, torch.zeros(3), BUDGET)
        with profiling.enable():
            got = render_once(pv, cp, torch.zeros(3), BUDGET)
        assert torch.equal(want.color, got.color)
        assert torch.equal(want.final_t, got.final_t)


def _switched_on(how):
    if how == "enable":
        return profiling.enable()
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_every_train_stage_once_per_step_in_order(how):
    tr = _trainer("cpu")
    with _switched_on(how), cs.binning_spy() as seen:
        _run(tr)
    entries = list(profiling._REG.host)
    step = [ID[n] for n in profiling.TRAIN_STAGES] + [ID[profiling.END]]
    assert _ids(entries) == step * 6
    # the stages tile each step: their sum is first boundary to end
    times = [t for i, t in entries if i < len(profiling.STAGES)]
    span = sum(times[k + len(step) - 1] - times[k]
               for k in range(0, len(times), len(step)))
    snap = profiling.snapshot()
    stages = snap["stages"]
    assert set(stages) == set(profiling.TRAIN_STAGES)
    assert all(s["count"] == 6 for s in stages.values())
    assert sum(s["s"] for s in stages.values()) == pytest.approx(
        span * 1e-9, rel=1e-9)
    assert snap["stages_open"] == 0 and snap["stamps_dropped"] == 0
    # binning's two counters and the pad need and spill folded from them
    # a render, six renders; no training render takes the fused
    # preprocess kernel
    assert {n: c["count"] for n, c in snap["counters"].items()} == \
        dict.fromkeys(("num_rendered", "total_padded", "pads_spilled",
                       profiling.PAD_NEED, profiling.PAD_SPILL), 6)
    assert cs.check_counters(snap, seen, "train") == 6


@pytest.mark.parametrize("how", ["enable", "profiler"])
@pytest.mark.parametrize("variable_sh", [False, True])
def test_every_view_stage_once_per_frame_in_order(how, variable_sh):
    pv = _pool_view("cpu", variable_sh)
    cams = cs.ring_cameras(SCENE["width"], SCENE["height"], n_views=2)
    with _switched_on(how), cs.binning_spy() as seen:
        outs = [render_view(pv, c, torch.zeros(3), BUDGET)[0] for c in cams]
    names = profiling.VIEW_STAGES[0 if variable_sh else 1:]
    frame = [ID[n] for n in names] + [ID[profiling.END]]
    assert _ids(profiling._REG.host) == frame * 2
    snap = profiling.snapshot()
    assert {n: s["count"] for n, s in snap["stages"].items()} == \
        dict.fromkeys(names, 2)
    assert cs.check_counters(snap, seen, "view") == 2
    c = snap["counters"]
    assert c["num_rendered"]["sum"] == sum(int(o.num_rendered) for o in outs)
    assert 0 < c["pad_need_permille"]["max"] < 1000
    assert c["total_padded"]["max"] % 128 == 0


def test_tile_counts_rows_absent_on_the_cpu():
    """The plain version of the tile counts records no counter: only a
    card's kernel stamps tile_counts_rows."""
    pv = _pool_view("cpu", False)
    cam = cs.ring_cameras(SCENE["width"], SCENE["height"], n_views=1)[0]
    with profiling.enable():
        render_view(pv, cam, torch.zeros(3), BUDGET)
    counters = profiling.snapshot()["counters"]
    assert counters["num_rendered"]["count"] == 1
    assert "tile_counts_rows" not in counters


def test_the_pad_need_is_folded_from_a_renders_two_counters():
    """The fold's arithmetic on written entries: each total_padded, tagged
    with its render's slack pool, against the num_rendered before it."""
    one = torch.tensor(0, dtype=torch.int32)
    with profiling.enable():
        for nr, tp, pool in ((1000, 1640, 512), (7, 128, 1024),
                             (5000, 5000, 256), (0, 0, 128)):
            profiling.count("num_rendered", one + nr)
            profiling.count("total_padded", one + tp, aux=pool)
        profiling.count("total_padded", one + 4)  # no pool: no pad need
    c = profiling.snapshot()["counters"]
    assert c["num_rendered"] == {"sum": 6007, "max": 5000, "count": 4}
    assert c["total_padded"] == {"sum": 6772, "max": 5000, "count": 5}
    # 640 of 512 slots, 121 of 1024, none
    assert c[profiling.PAD_NEED] == {"sum": 1250 + 118, "max": 1250,
                                     "count": 4}


def test_the_spill_is_folded_from_a_renders_two_counters():
    """The fold's spill on written entries: each num_rendered tagged with
    its render's aligned budget, each total_padded with its slack pool;
    the pads past the pool count where the layout fits in budget + pool
    slots, and a num_rendered without its budget folds no spill."""
    one = torch.tensor(0, dtype=torch.int32)
    with profiling.enable():
        for nr, tp, aligned in ((800, 1440, 1024), (100, 300, 1024),
                                (1000, 1640, 1024), (800, 1440, 0)):
            profiling.count("num_rendered", one + nr, aux=aligned)
            profiling.count("total_padded", one + tp, aux=512)
    c = profiling.snapshot()["counters"]
    # 128 pads past the pool; within it; a layout past its 1,536 slots
    assert c[profiling.SPILLED] == {"sum": 128, "max": 128, "count": 3}
    assert c[profiling.PAD_SPILL] == {"sum": 250, "max": 250, "count": 3}
    assert c[profiling.PAD_NEED]["count"] == 4


def test_spans_in_the_chrome_trace_with_their_parents(tmp_path):
    tr = _trainer("cpu")
    profiling.start_trace(str(tmp_path))
    _run(tr)
    path = profiling.stop_trace()
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("r3dgs.")]

    def within(child, parent):
        kids = [e for e in events if e["name"] == child]
        dads = [e for e in events if e["name"] == parent]
        assert kids and dads, (child, parent)
        return all(any(d["ts"] <= k["ts"] and k["ts"] + k["dur"]
                       <= d["ts"] + d["dur"] for d in dads) for k in kids)

    for part in ("prepare", "replays", "read", "unpack"):
        assert within(f"r3dgs.step_group.{part}", "r3dgs.step_group")
    assert within("r3dgs.surgery.prune_dead", "r3dgs.step")
    spans = profiling.snapshot()["spans"]
    assert spans["r3dgs.step"]["calls"] == 3
    assert spans["r3dgs.step_group.prepare"]["calls"] == 1


def test_the_switch_follows_a_profiler_between_calls():
    tr = _trainer("cpu")
    tr.step(1)
    assert not profiling.tracing("cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.tracing("cpu")
        tr.step_group(range(2, 4))
    assert not profiling.tracing("cpu")
    tr.step_group(range(4, 6))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.step(6)
    stages = profiling.snapshot()["stages"]
    assert all(s["count"] == 3 for s in stages.values())


def test_budget_redos_and_a_stage_left_open_are_counted():
    tr = _trainer("cpu", budget=64)
    with profiling.enable():
        tr.step(1)
        tr.step_group(range(2, 4))
        profiling.stage("binning", "cpu")
        profiling.stage("preprocess", "cpu")  # binning left open
    snap = profiling.snapshot()
    assert snap["counters"]["budget_redos"]["sum"] >= 2
    assert snap["stages_open"] == 2  # binning, and preprocess still open
    # every attempt is a whole step: a redo is timed as one more step
    attempts = snap["counters"]["num_rendered"]["count"]
    assert snap["stages"]["binning"]["count"] == attempts


def test_a_full_ring_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    tr = _trainer("cpu")
    with profiling.enable():
        tr.step(1)
    snap = profiling.snapshot()
    # ten boundaries, the end and two counters: five past the ring
    assert snap["stamps_dropped"] == 5


def test_the_benchmark_reads_one_stage_a_unit_or_nothing(monkeypatch):
    from splatbench import program_trace as pt

    tr = _trainer("cpu")
    with profiling.enable():
        _run(tr)
    record = {"kind": "train", "traced_iterations": 6}
    total = sum(pt.stage_ms(record, "train", (n,))
                for n in profiling.TRAIN_STAGES)
    assert total > 0
    assert pt.stage_ms(record, "train", ("loss", "loss_bwd")) > 0
    assert pt.span_ms(record, "train", ("r3dgs.step_group.prepare",)) > 0
    assert pt.stage_ms({"kind": "train", "traced_iterations": 5}, "train",
                       ("preprocess",)) is None
    assert pt.stage_ms({"kind": "view", "traced_frames": 6}, "view",
                       ("preprocess",)) is not None
    assert pt.stage_ms(record, "view", ("preprocess",)) is None
    assert pt.counter_sum(record, "train", "graph_capture_s") is None
    real = profiling.snapshot
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: dict(real(), stamps_dropped=1))
    assert pt.stage_ms(record, "train", ("preprocess",)) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert pt.snapshot() is None
    assert pt.stage_ms(record, "train", ("preprocess",)) is None


def test_a_compression_step_times_its_parts_and_counts_its_rows(tmp_path):
    """The eager step's stages, then mercy's (MERCY_STAGES, END), then per
    transmittance render (two a camera) cull_render, cull_stats, END:
    the render's own boundaries muted, nothing left open.  Their spans
    nest in r3dgs.surgery.mercy / .cull; mercy_pruned and sh_demoted
    equal the host's own counts."""
    tr = _compressing_trainer()
    before = tr.state.pool.degrees[tr.state.pool.alive].clone()
    profiling.start_trace(str(tmp_path))
    tr.step(PRUNE_AT)
    path = profiling.stop_trace()
    step = [ID[n] for n in profiling.TRAIN_STAGES] + [ID[profiling.END]]
    mercy = [ID[n] for n in profiling.MERCY_STAGES] + [ID[profiling.END]]
    cull = [ID[n] for n in profiling.CULL_STAGES] + [ID[profiling.END]]
    views = 2 * len(tr.cameras)
    assert _ids(profiling._REG.host) == step + mercy + cull * views
    snap = profiling.snapshot()
    counts = {n: s["count"] for n, s in snap["stages"].items()}
    assert counts == {**dict.fromkeys(profiling.TRAIN_STAGES, 1),
                      **dict.fromkeys(profiling.MERCY_STAGES, 1),
                      **dict.fromkeys(profiling.CULL_STAGES, views)}
    assert snap["stages_open"] == 0 and snap["stamps_dropped"] == 0
    c = snap["counters"]
    assert c["mercy_pruned"]["sum"] == tr.stats["n_points_mercied"] > 0
    pool = tr.state.pool
    after = pool.degrees[pool.alive]
    assert bool((before == 3).all())
    assert c["sh_demoted.variance_d0"]["sum"] == int((after == 0).sum())
    assert c["sh_demoted.distance_d1"]["sum"] == int((after == 1).sum())
    assert c["sh_demoted"]["count"] == 3  # the variance pass, two steps
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("r3dgs.")]

    def within(child, parent):
        kids = [e for e in events if e["name"] == child]
        dads = [e for e in events if e["name"] == parent]
        assert kids and dads, (child, parent)
        return all(any(d["ts"] <= k["ts"] and k["ts"] + k["dur"]
                       <= d["ts"] + d["dur"] for d in dads) for k in kids)

    for part in ("pixel_size", "knn", "intersect", "allocate", "select"):
        assert within(f"r3dgs.mercy.{part}", "r3dgs.surgery.mercy")
    for part in ("render", "stats"):
        assert within(f"r3dgs.cull.{part}", "r3dgs.surgery.cull")
        assert snap["spans"][f"r3dgs.cull.{part}"]["calls"] == views


def test_a_compression_step_records_nothing_while_tracing_is_off():
    off, on = _compressing_trainer(), _compressing_trainer()
    off.step(PRUNE_AT)
    snap = profiling.snapshot()
    assert snap["stages"] == snap["spans"] == snap["counters"] == {}
    assert snap["stages_open"] == 0
    with profiling.enable():
        on.step(PRUNE_AT)
    assert profiling.snapshot()["counters"]["mercy_pruned"]["count"] == 1
    for a, b in zip(T.carried(off.state), T.carried(on.state)):
        assert torch.equal(a, b)
    assert torch.equal(off.state.pool.degrees, on.state.pool.degrees)
    assert torch.equal(off.state.pool.alive, on.state.pool.alive)


def test_the_benchmark_reads_the_compression_stages_per_event():
    from splatbench.event_trace import stage_ms

    tr = _compressing_trainer()
    with profiling.enable():
        tr.step(PRUNE_AT)
    views = 2 * len(tr.cameras)
    record = {"kind": "train", "traced_events": 1,
              "traced_cull_renders": views}
    assert stage_ms(record, profiling.MERCY_STAGES, "traced_events") > 0
    assert stage_ms(record, profiling.CULL_STAGES,
                    "traced_cull_renders") > 0
    assert stage_ms(dict(record, traced_cull_renders=views - 1),
                    profiling.CULL_STAGES, "traced_cull_renders") is None
    assert stage_ms(dict(record, kind="view"), ("knn",),
                    "traced_events") is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_replayed_step_graph_stamps_only_while_tracing(cuda):
    tr = _trainer(cuda)
    tr.step_group(range(1, 4))  # captures the step with tracing off
    assert tr.graph_captures == 1
    assert profiling.snapshot()["stages"] == {}
    with profiling.enable():
        tr.step_group(range(4, 7))
    snap = profiling.snapshot()
    assert tr.graph_captures == 1  # traced without a new capture
    assert {n: s["count"] for n, s in snap["stages"].items()} == \
        dict.fromkeys(profiling.TRAIN_STAGES, 3)
    assert all(s["s"] > 0 for s in snap["stages"].values())
    assert snap["stages_open"] == 0 and snap["stamps_dropped"] == 0
    assert snap["counters"]["graph_capture_s"]["count"] == 1
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        tr.step_group(range(7, 9))
    tr.step_group(range(9, PRUNE_AT))
    stages = profiling.snapshot()["stages"]
    assert all(s["count"] == 5 for s in stages.values())


@pytest.mark.gpu
def test_graphed_frame_stamps_only_while_tracing(cuda):
    from reduced3dgs_torch import graphs
    from reduced3dgs_torch.train.trainer import camera_from_vector, \
        camera_vector

    pv = _pool_view(cuda, True)
    cams = cs.ring_cameras(SCENE["width"], SCENE["height"], n_views=2)
    vec = torch.as_tensor(camera_vector(cams[0]), device=cuda)
    cp = camera_from_vector(vec, SCENE["width"], SCENE["height"])
    with cs.binning_spy() as seen:  # the warm-up's binning, the capture's
        run = graphs.runner(lambda: render_once(pv, cp, torch.zeros(
            3, device=cuda), BUDGET), cuda)
    run.replay()
    want = run.out.color.clone()
    assert profiling.snapshot()["stages"] == {}
    with profiling.enable():
        for _ in range(4):
            run.replay()
    got = run.out.color.clone()
    run.replay()
    snap = profiling.snapshot()
    assert torch.equal(want, got)
    assert {n: s["count"] for n, s in snap["stages"].items()} == \
        dict.fromkeys(profiling.VIEW_STAGES, 4)
    assert snap["spans"]["r3dgs.graph.replay"]["calls"] == 4
    # the captured binning's outputs hold the last replay's values, and
    # each replay rendered the same view
    assert cs.check_counters(snap, seen[-1:] * 4, "graphed frame") == 4


@pytest.mark.gpu
def test_a_full_device_ring_counts_what_it_drops(cuda, monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    profiling._REG.rings.clear()  # a ring of the patched size
    try:
        pv = _pool_view(cuda, False)
        cp = cs.ring_cameras(SCENE["width"], SCENE["height"],
                             n_views=1)[0].params(cuda)
        with profiling.enable():
            for _ in range(2):
                render_once(pv, cp, torch.zeros(3, device=cuda), BUDGET)
        snap = profiling.snapshot()
        # four boundaries and four counters a render (binning's two, the
        # tile counts' and the fused preprocess's)
        assert snap["stamps_dropped"] == 2 * 8 - 8
    finally:
        profiling._REG.rings.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [BUDGET, 1 << 9])  # ample; splits one
def test_tile_counts_rows_once_a_replayed_frame(cuda, budget):
    """tile_counts_rows on a replayed frame graph: once a replay, its sum
    the rows csrc/tile_counts.cu added -- the ranks with instances that
    fit (a nonempty segment), the rows that fit whole and the one the
    budget splits."""
    from reduced3dgs_torch import graphs

    pv = _pool_view(cuda, False)
    cp = cs.ring_cameras(SCENE["width"], SCENE["height"],
                         n_views=1)[0].params(cuda)
    bg = torch.zeros(3, device=cuda)
    with cs.binning_spy() as seen:
        run = graphs.runner(lambda: render_once(pv, cp, bg, budget), cuda)
    profiling.reset()
    with profiling.enable():
        for _ in range(3):
            run.replay()
    got = profiling.snapshot()["counters"]["tile_counts_rows"]
    nr, _, _, _, sb = seen[-1]
    seg = (sb[1:] - sb[:-1]).cpu()
    rows = int((seg > 0).sum())
    assert got == {"sum": 3 * rows, "max": rows, "count": 3}
    # the truncated frame's instances end at the budget, inside a row
    assert int(sb[-1]) == min(budget, int(nr))
