"""The surgery on row shards (parallel/sharded.py:ShardRows, the
param_shard ShardedTrainer) against the port's single-card surgery.

The ranks are gloo processes on the CPU (launch.spawn_local,
OMP_NUM_THREADS=1), one spawn group per mesh shape (a module fixture);
they run tests/torch_sharded_surgery_child.py, which imports no jax.

* Every event (densify with store_grads on and off, densify out of free
  slots, capacity growth, opacity reset, dead prune, mercy of each
  MERCY_TYPES) on a 256-slot pool, sharded on (1, 2) and (1, 4), against
  the same event on the whole state from the same generator: every leaf
  of gather_state's result, the pending gradients, the statistics and
  the generator's next draw bit for bit; also on a pool whose upper half
  of the slots holds no alive row.
* The SH cull (ShardRows.transmittance, strips of tile rows): the same
  degrees, and features_dc / features_rest equal wherever the degrees
  are; per camera the per-primitive transmittance sums within K4's
  tolerance of tests/test_torch_trans.py (atol 1e-3, rtol 1e-3; summed
  over strips, in another order), touched and radii equal.
* Collectives: none but those that move rows to a new owner carries more
  than 64 B per global capacity row (ShardRows.log); a ShardedTrainer run
  never calls gather_state or sync_state (made to raise).
* A ShardedTrainer run on (1, 4) through growth, densify, reset, mercy,
  dead prune and a cull against the single-card Trainer (the tolerances
  of test_torch_parallel.py::test_sharded_trainer_surgery_parity), and on
  (2, 2) the two data groups hold the same bits.
"""

import numpy as np
import pytest
import torch_sharded_surgery_child as child

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.parallel import launch

SEED = 3
EVENTS = ("densify_store_grads", "densify", "grow", "opacity_reset",
          "prune_dead", "mercy_redundancy_opacity",
          "mercy_redundancy_random", "mercy_opacity",
          "mercy_redundancy_opacity_opacity")
# the trainer runs: densify at 3, 6 and 9 (the first grows the pool from
# 256 to 1024 slots), an opacity reset at 6, mercy at 3, 9 and 12, dead
# prunes at 12, the cull at 13 (at SH degree 0: it demotes every row)
TRAIN = dict(densify_from_iter=1, densification_interval=3,
             densify_until_iter=10, opacity_reset_interval=6,
             mercy_points=True, mercy_interval=1, prune_dead_points=True,
             store_grads=True, iterations=5000,
             densify_grad_threshold=1e-5)
ITERS = 13
MAX_BYTES_PER_ROW = 64


def spawn(fn, world, *args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return launch.spawn_local(fn, world, "gloo", "cpu", *args)


@pytest.fixture(scope="module")
def ranks_1x2():
    return spawn(child.events, 2, SEED)


@pytest.fixture(scope="module")
def ranks_1x4():
    return spawn(child.events, 4, SEED)


@pytest.fixture(scope="module")
def trainer_1x4():
    return spawn(child.trainer_run, 4, (1, 4), SEED, TRAIN, ITERS)


@pytest.fixture(scope="module")
def trainer_2x2():
    return spawn(child.trainer_run, 4, (2, 2), SEED, TRAIN, ITERS)


def _same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{what}: {k}")


def _small(log, what):
    assert log, what
    assert {e["op"] for e in log} <= {"all_gather", "all_reduce",
                                      "reduce_scatter", "broadcast"}
    for e in log:
        per_row = e["bytes"] / e["capacity"]
        assert e["move"] or per_row <= MAX_BYTES_PER_ROW, (what, e)


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
@pytest.mark.parametrize("pool", ["events", "lonely"])
@pytest.mark.parametrize("event", EVENTS)
def test_event_on_shards_equals_single_card(request, mesh, pool, event):
    """One event on the row shards against the single-card event on the
    same whole state, on every rank: bit for bit."""
    for r in request.getfixturevalue(f"ranks_{mesh}"):
        sharded, single, (s_stats, o_stats) = r[pool][event]
        _same(sharded, single, f"{mesh} {pool} {event} rank {r['rank']}")
        assert s_stats == o_stats


def test_events_do_work(ranks_1x2):
    """The pools exercise what the events decide: clones, splits, prunes,
    drops for want of capacity, mercy of every type, dead rows moved."""
    r = ranks_1x2[0]
    for pool in ("events", "lonely"):
        d = r[pool]["densify_store_grads"][2][1]
        assert d["n_points_split"] > 0 and d["n_points_pruned"] > 0
        for kind in EVENTS[5:]:
            assert r[pool][kind][2][1]["n_points_mercied"] > 0, (pool, kind)
    assert r["events"]["densify"][2][1]["n_points_cloned"] > 0
    full = r["full"][2][1]
    assert full["n_dropped_capacity"] > 0 and full["n_points_split"] > 0
    grown = r["events"]["grow"][1]
    assert grown["alive"].shape == (1024,) and not grown["alive"][256:].any()
    lonely = r["lonely"]["densify"][1]["alive"]
    assert lonely[128:].any()  # new rows reach the empty upper half


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_densify_out_of_free_slots(request, mesh):
    """Densify with fewer free slots than wanted rows: the same rows
    dropped (n_dropped_capacity) and every leaf bit for bit."""
    for r in request.getfixturevalue(f"ranks_{mesh}"):
        sharded, single, (s_stats, o_stats) = r["full"]
        _same(sharded, single, f"{mesh} full pool rank {r['rank']}")
        assert s_stats == o_stats


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_cull_on_shards(request, mesh):
    """cull_sh_bands through ShardRows.transmittance against the whole
    render's: equal degrees, the coefficients equal where the degrees
    are, the transmittance sums within K4's tolerance."""
    for r in request.getfixturevalue(f"ranks_{mesh}"):
        c = r["cull"]
        got, want = c["sharded"], c["single"]
        np.testing.assert_array_equal(got["degrees"], want["degrees"])
        assert len(np.unique(want["degrees"])) == 4  # every degree left
        same = got["degrees"] == want["degrees"]
        for k in ("features_dc", "features_rest"):
            np.testing.assert_array_equal(got[k][same], want[k][same])
        for (radii, t_sum, touched), (w_radii, w_sum, w_touched) in \
                c["trans"]:
            np.testing.assert_array_equal(radii, w_radii)
            np.testing.assert_array_equal(touched, w_touched)
            np.testing.assert_allclose(t_sum, w_sum, atol=1e-3, rtol=1e-3)
            assert (w_touched > 0).sum() > 20


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_event_collectives_stay_small(request, mesh):
    """Every collective of the events and the cull: at most 64 B per
    global capacity row unless it moves rows to a new owner; the moves
    (densify's all_gather, growth's broadcasts) did run."""
    for r in request.getfixturevalue(f"ranks_{mesh}"):
        _small(r["log"], mesh)
        moves = {e["op"] for e in r["log"] if e["move"]}
        assert moves == {"all_gather", "broadcast"}


def test_trainer_never_gathers_the_whole_state(trainer_1x4):
    """ShardedTrainer on (1, 4) through every event with gather_state and
    sync_state made to raise: it ran, each rank held a quarter of the
    grown pool, and its surgery collectives stayed small."""
    for r in trainer_1x4:
        assert r["events"] == {"densify": 3, "reset": 1, "prune_dead": 1,
                               "mercy": 3, "cull": 1}
        assert r["rows_held"] * 4 == r["state"]["alive"].shape[0] == 1024
        _small(r["log"], "trainer (1, 4)")
        assert {e["op"] for e in r["log"] if e["move"]} == {
            "all_gather", "broadcast"}


def test_trainer_matches_single_card(trainer_1x4):
    """The (1, 4) run against the single-card Trainer from the same pool
    and seed: the same alive rows, statistics and events; losses within
    rtol 2e-4 and alive parameters within atol 2e-4 / rtol 1e-3 (the
    sharded step's sums run in another order)."""
    ref = child.trainer_run(0, 1, "cpu", None, SEED, TRAIN, ITERS)
    assert ref["stats"]["n_points_mercied"] > 0
    assert ref["stats"]["n_points_split"] > 0
    for r in trainer_1x4:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=2e-4)
        assert r["stats"] == ref["stats"] and r["events"] == ref["events"]
        alive = ref["state"]["alive"]
        np.testing.assert_array_equal(r["state"]["alive"], alive)
        np.testing.assert_array_equal(r["state"]["degrees"],
                                      ref["state"]["degrees"])
        for name in ("xyz", "scaling", "opacity", "features_dc"):
            k = f"param_{name}"
            np.testing.assert_allclose(r["state"][k][alive],
                                       ref["state"][k][alive], atol=2e-4,
                                       rtol=1e-3, err_msg=k)


def test_data_groups_agree(trainer_2x2):
    """ShardedTrainer on (2, 2): both data groups hold the same bits in
    every leaf after every event, and the broadcast that makes them
    agree goes in pieces of at most 64 B a capacity row."""
    for a, b in ((0, 2), (1, 3)):
        _same(trainer_2x2[a]["state"], trainer_2x2[b]["state"],
              f"ranks {a} and {b}")
    for r in trainer_2x2:
        _small(r["log"], "trainer (2, 2)")
        assert any(e["op"] == "broadcast" and not e["move"]
                   for e in r["log"])
    assert trainer_2x2[0]["events"]["mercy"] == 3


def test_children_import_no_jax(ranks_1x2, ranks_1x4, trainer_1x4,
                                trainer_2x2):
    for res in (ranks_1x2, ranks_1x4, trainer_1x4, trainer_2x2):
        assert not any(r["jax_imported"] for r in res)
