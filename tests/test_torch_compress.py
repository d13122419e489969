"""The compression iteration of the paper's `full_final` schedule
(dead-prune, mercy, the SH-band cull) in the port's Trainer, held to the
benchmark's plain reference (splatbench/reference/compress.py, which
imports nothing of the program) at a small seeded size: the benchmark's
`m360_full_final` configuration (the `m360_full` scene under full_final)
cut to 20,000 primitives and 8 cameras at 160x120.

* The Trainer is built from cameras alone (no dataset Scene): its
  redundancy metric is the reference's on the program's neighbour lists,
  and a dataset Scene's over the same cameras;
* one Trainer.step at the cull iteration gives the reference's alive
  mask and degrees exactly and its coefficients within 1e-6: the
  dead-prune's rule, mercy's redundancy_opacity_opacity decision and the
  cull's two passes on the reference's own transmittance renders;
* an overflowing transmittance render is redone up the budget ladder
  (renderer.fit, budget_redos) and gives the statistics of a render
  with room;
* the kNN's plain version (the card kernel's, csrc/knn.cu) orders by
  (distance, row);
* the benchmark's cycles (splatbench/generators/compress.py), restored
  from one snapshot, give the same bits twice (at the benchmark's
  rehearsal size, splatbench/tests/tiny.py, as chip_smoke.py's phase 25
  is rehearsed: the cull's plain transmittance renders are slow here).

This file imports no JAX.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chip_rehearsal import cpu_card  # noqa: F401 (a fixture)
from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.ops import knn as tknn
from reduced3dgs_torch.ops import sh_culling
from reduced3dgs_torch.ops import redundancy
from reduced3dgs_torch.scene import Scene
from reduced3dgs_torch.train import trainer as T
from reduced3dgs_torch.utils import profiling
from splatbench import scene
from splatbench.generators import compress as gen
from splatbench.generators.train import view_of
from splatbench.reference import compress as ref
from splatbench.run import HERE, load_json
from splatbench.tests import tiny

SEED = 2 ** 31 + 24
AT = 15000
CPU = torch.device("cpu")


def small_config():
    cfg = copy.deepcopy(load_json(HERE / "configs" / "m360_full_final.json"))
    cfg.update(width=160, height=120, train_cameras=8, test_cameras=2,
               primitives=20_000, capacity=32_768)
    cfg["assumed"]["scale_base"] = 0.02
    return cfg


def small_traffic(**over):
    t = load_json(HERE / "traffic" / "compress.json")
    t.update(cycle_iterations=4, count_samples=2, **over)
    return t


@functools.cache
def _driver(size="small"):
    """The benchmark's trainer at the compression iteration, and its
    snapshot (shared: every test restores it before use)."""
    cfg = small_config() if size == "small" else tiny.config("m360_full_final")
    return gen.Compress(cfg, small_traffic(), SEED, CPU)


def _restored(size):
    d = _driver(size)
    gen.restore(d.trainer, d.snap)
    return d


@pytest.fixture
def drv():
    return _restored("small")


def _spied_lists(monkeypatch):
    seen = {}
    real = redundancy.knn_indices

    def spy(points, k, **kw):
        out = real(points, k, **kw)
        n = int(torch.isfinite(points).all(1).sum())
        seen["lists"] = out[:n].clone()
        return out

    monkeypatch.setattr(redundancy, "knn_indices", spy)
    return seen


def _reference_cameras(cfg):
    return [(torch.as_tensor(p), torch.as_tensor(i), cfg["width"],
             cfg["height"]) for p, i in gen.reference_cameras(cfg, SEED)]


def test_the_trainer_names_the_compression_events(drv):
    tr = drv.trainer
    assert tr.events_at(AT) == ("prune_dead", "mercy", "cull")
    assert tr.events_at(AT + 1) == () and tr.fusible(AT + 1)
    assert tr.events_at(AT + 1000) == ("prune_dead", "mercy")


def test_the_redundancy_metric_from_the_trainers_cameras(drv, monkeypatch):
    """The Trainer's metric (its own cameras, no Scene) equals a dataset
    Scene's over the same cameras and the reference's on the program's
    neighbour lists."""
    tr = drv.trainer
    seen = _spied_lists(monkeypatch)
    red, cube = tr.calculate_redundancy_metric(pixel_scale=1.0)
    lists = seen["lists"]

    class Cameras:
        pool = tr.state.pool

        def get_train_cameras(self):
            return tr.cameras

    red_s, cube_s = Scene.calculate_redundancy_metric(Cameras(),
                                                      pixel_scale=1.0)
    assert torch.equal(red, red_s) and torch.equal(cube, cube_s)
    pool = tr.state.pool
    rows = torch.nonzero(pool.alive).flatten()
    want = ref.redundancy(pool.params.xyz[rows], pool.get_scaling()[rows],
                          pool.get_rotation()[rows], lists,
                          _reference_cameras(drv.cfg), 1.0)
    assert torch.equal(red[rows].long(), want)
    assert not red[~pool.alive].any()
    assert int(want.max()) > 3  # the scene's centre overlaps


def test_one_compression_step_matches_the_reference(drv, monkeypatch):
    """Trainer.step(15000): the alive mask and the degrees exactly, the
    coefficients within 1e-6 of the reference's dead-prune, mercy (on the
    program's neighbour lists) and two cull passes (on the reference's
    own transmittance renders)."""
    tr, cfg = drv.trainer, drv.cfg
    before = tr.state.pool
    seen = _spied_lists(monkeypatch)
    tr.step(AT)
    after = tr.state.pool
    opt = tr.opt_cfg
    # the dead-prune
    alive = before.alive & ~(before.get_opacity()[:, 0] < 1.0 / 255.0)
    # mercy on the pruned state
    rows = torch.nonzero(alive).flatten()
    red = torch.zeros(alive.shape[0], dtype=torch.int64)
    red[rows] = ref.redundancy(
        before.params.xyz[rows], before.get_scaling()[rows],
        before.get_rotation()[rows], seen["lists"], _reference_cameras(cfg),
        opt.box_size)
    alive = ref.mercy(alive, red, before.get_opacity()[:, 0],
                      opt.lambda_mercy, opt.mercy_minimum)
    assert torch.equal(after.alive, alive)
    assert 0 < int(before.alive.sum() - alive.sum()) < 0.5 * len(rows)
    # the cull, on the reference's renders (the passes change colours
    # only, so both take the same transmittance)
    leaves = {k: getattr(before.params, k) for k in scene.LEAVES}
    sh = before.features()
    views = []
    for i, pose in enumerate(scene.training_poses(cfg, SEED)):
        cam = view_of(cfg, pose, CPU)
        views.append((torch.as_tensor(np.asarray(pose[2], np.float32)),
                      *ref.render_transmittance(leaves, sh, before.degrees,
                                                alive, cam)))
    want_sh, want_deg = ref.cull(sh, before.degrees, alive,
                                 before.params.xyz, views, views,
                                 opt.std_threshold, opt.cdist_threshold)
    assert torch.equal(after.degrees, want_deg.to(after.degrees.dtype))
    hist = torch.bincount(after.degrees[alive].long(), minlength=4)
    assert hist[0] > 0 and hist[3] > 0 and hist[1:3].sum() > 0
    got = after.features()
    np.testing.assert_allclose(got[alive].numpy(), want_sh[alive].numpy(),
                               rtol=0, atol=1e-6)


def test_the_coefficient_gap_reads_the_dc_term_of_rows_of_equal_degree():
    """splatbench's feature_gap: a wrong DC term on a row of the right
    degree reads; a row whose degree differs is cull_degree_mismatches'
    and left out; so are the dead rows."""
    g = torch.Generator().manual_seed(3)
    sh = torch.randn((6, 16, 3), generator=g)
    deg = torch.tensor([0, 1, 3, 3, 2, 0])
    alive = torch.tensor([True, True, True, True, True, False])
    assert gen.coefficient_gap(sh, deg, sh.clone(), deg, alive) == 0.0
    wrong = sh.clone()
    wrong[0, 0] += 0.25
    assert gen.coefficient_gap(wrong, deg, sh, deg, alive) == 0.25
    other = deg.clone()
    other[0] = 1  # its bands differ by design
    assert gen.coefficient_gap(wrong, deg, sh, other, alive) == 0.0
    wrong[5, 3] += 1.0  # dead
    assert gen.coefficient_gap(wrong, deg, sh, other, alive) == 0.0


def test_a_wrong_weighted_mean_shows_only_in_the_coefficient_gap():
    """The calibration's planted fault dc_mean_skipped (the variance pass
    keeps the DC term): the same alive rows and degrees as the program,
    and a coefficient gap far over the cell's limit."""
    from splatbench import calibrate_compress as cal

    drv = _restored("tiny")
    tr = drv.trainer
    tr.step(AT)
    good = (tr.state.pool.features().clone(), tr.state.pool.degrees.clone(),
            tr.state.pool.alive.clone())
    gen.restore(tr, drv.snap)
    with cal.fault("dc_mean_skipped"):
        tr.step(AT)
    pool = tr.state.pool
    gen.restore(tr, drv.snap)
    assert torch.equal(pool.alive, good[2])
    assert torch.equal(pool.degrees, good[1])
    assert int((good[1][good[2]] == 0).sum()) > 0  # the pass demoted rows
    limit = load_json(HERE / "limits" / "m360_full.compress.json")[
        "feature_gap"]
    assert gen.coefficient_gap(pool.features(), pool.degrees, *good) \
        > 100 * limit


def test_two_cycles_from_one_snapshot_are_bit_identical():
    drv = _restored("tiny")
    tr = drv.trainer
    runs = []
    for _ in range(2):
        _, ms = drv.cycle()
        st = tr.state
        runs.append(([t.clone() for t in T.carried(st)]
                     + [st.pool.degrees.clone(), st.pool.alive.clone()],
                     [float(m["loss"]) for m in ms], dict(tr.budgets),
                     st.opt.step, dict(tr.stats)))
    (a, la, ba, sa, xa), (b, lb, bb, sb, xb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert la == lb and ba == bb and sa == sb and xa == xb
    assert sa.xyz == AT - 1 + len(drv.group)  # the group stepped Adam


def test_an_overflowing_cull_render_is_redone_at_a_larger_budget():
    drv = _restored("tiny")
    tr = drv.trainer
    pool = tr.state.pool
    need = max(tr.budgets.values())
    with profiling.enable():
        low = sh_culling.calculate_colours_variance(
            pool, tr.cameras, budget=64, max_sh_degree=3)
    redos = profiling.snapshot()["counters"]["budget_redos"]["sum"]
    profiling.reset()
    with profiling.enable():
        roomy = sh_culling.calculate_colours_variance(
            pool, tr.cameras, budget=need, max_sh_degree=3)
    assert "budget_redos" not in profiling.snapshot()["counters"]
    profiling.reset()
    assert redos >= len(tr.cameras)
    for a, b in zip(low, roomy):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_the_plain_knn_orders_by_distance_then_row():
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(0, 1, (300, 3)), np.zeros((40, 3)),
                          np.ones((3, 3))]).astype(np.float32)
    d2, idx = tknn.knn_sorted_plain(torch.as_tensor(pts), 30, rows=64)
    dd = ((pts[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(dd, np.inf)
    want = np.argsort(dd, axis=1, kind="stable")[:, :30]
    np.testing.assert_array_equal(idx.numpy(), want)
    # forty copies of one point: each lists the other copies, lowest first
    assert idx[300].tolist() == list(range(301, 331))
    assert idx[301].tolist() == [300] + list(range(302, 331))
    assert not d2[300].any()
    few_d2, few_i = tknn.knn_sorted_plain(torch.as_tensor(pts[:5]), 6)
    assert bool(torch.isinf(few_d2[:, 4:]).all())
    assert bool((few_i[:, 4:] == -1).all())


def test_phase25_rehearsal():
    """chip_smoke.py's phase 25 (the compression iteration's parts,
    counters and host counts) at the rehearsal size."""
    out = cs.compress_event(CPU, SEED, tiny.config("m360_full_final"),
                            say=lambda *a: None)
    assert out["mercy_pruned"] > 0 and out["sh_demoted"]["variance_d0"] > 0
    assert out["budget_redos"] == 0 and out["alive"] < 1500


def test_phase25_full_size_check_rehearsal(cpu_card, monkeypatch):
    """chip_smoke.knn_full_size at 3,000 rows, the kernel's plain version
    standing in for it: every row sampled and held to the reference's
    brute force, the readings of the kernels line; a list off by one row
    fails it."""
    pts = torch.as_tensor(np.random.default_rng(9).normal(
        0, 1, (3000, 3)).astype(np.float32))
    monkeypatch.setattr(tknn, "_knn_cuda", tknn.knn_sorted_plain)
    out = cs.knn_full_size(CPU, SEED, pts, plain_chunks=2)
    assert out["sampled"] == 3000 and out["mismatches"] == 0
    assert out["rows"] == 3000 and out["plain_ms"] > 0
    assert 0 < out["bound_ms"] < out["ms"]

    def off(points, k):
        d2, idx = tknn.knn_sorted_plain(points, k)
        idx[17, -1] = (idx[17, -1] + 1) % points.shape[0]
        return d2, idx

    monkeypatch.setattr(tknn, "_knn_cuda", off)
    with pytest.raises(RuntimeError, match="differ from brute force on 1 "):
        cs.knn_full_size(CPU, SEED, pts, plain_chunks=1)


def test_the_blocked_ladder_counts_its_rung_or_its_fallback(monkeypatch):
    """The CPU's blocked kNN: the query blocks certified, keyed by the
    rung, or the rows brute force answers; nothing while tracing is
    off."""
    pts = torch.as_tensor(np.random.default_rng(7).normal(
        0, 0.15, (900, 3)).astype(np.float32)[:600])
    tknn._blocked_knn(pts, 6, box=128)
    assert profiling.snapshot()["counters"] == {}
    with profiling.enable():
        tknn._blocked_knn(pts, 6, box=128)
        monkeypatch.setattr(tknn, "_M_LADDER", (1,))
        with pytest.warns(RuntimeWarning, match="falling back"):
            tknn._blocked_knn(pts, 6, box=128)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    rungs = [k for k in counters if k.startswith("knn_certified_blocks.m")]
    assert len(rungs) == 1 and counters[rungs[0]]["sum"] == 5
    assert counters["knn_fallback_rows"]["sum"] == 600
