"""chip_smoke.py's phase 17 rehearsed on the CPU at a tiny size
(tests/chip_rehearsal.py): part 1, ShardedTrainer.step_group at world
size 1 in a gloo group (its CPU loop in place of the NCCL graph) against
the eager steps in both layouts; part 2, outside the group, the scaling
harness's loop beside its eager run, profile_components and
profile_trace in process and the two microbenchmarks as subprocesses;
the path's launch counts without the references'."""

import ast

import torch

import chip_smoke as cs
from chip_rehearsal import SMALL, cpu_card  # noqa: F401
from reduced3dgs_torch import profile_components
from reduced3dgs_torch.graphs import kernel_counters
from reduced3dgs_torch.parallel import launch


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
    assert "two gloo ranks (cpu): [('ran'" in out
    assert out.count("phase 17: scaling_bench graphed {") == 1
    assert out.count("phase 17: profile_components: ") == 7
    assert "phase 17: profile_trace: num_rendered=" in out
    assert "(other " in out
    assert out.count("phase 17: microbench_gather: w=") == 9
    assert out.count("phase 17: microbench_binning: ") == 17
    assert "phase 17: launches of the path" in out
