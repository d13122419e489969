"""The `serve` traffic at small sizes on the CPU: the program's FrameServer
comes out correct, a fault planted in its frames does not, and a program
without FrameServer stops at set-up, before any scene is made."""

import pytest
import torch

from splatbench import judge, run
from splatbench.tests import tiny

CPU = torch.device("cpu")
CELL = "m360_full.serve"


def _run(seed=2 ** 31 + 11, **traffic):
    bench = run.Bench()
    cell = bench.cell(CELL)
    out = run.measure(bench, cell, seed, 1.0, False, CPU,
                      cfg=tiny.config(cell["config"]),
                      traffic=tiny.traffic("serve", **traffic))
    ok, rows = judge.verdict(out.numbers, bench.limits(cell))
    return ok, dict((n, v) for n, v, _ in rows), out


def test_the_program_is_correct_at_a_small_size():
    ok, numbers, out = _run(check_from=2)
    assert ok, numbers
    assert out.attempted > 0 and out.e2e and out.record["kind"] == "view"


def test_a_serving_fault_is_not_correct(monkeypatch):
    from reduced3dgs_torch import render

    once = render.render_once

    def half(pv, cp, background, budget, *a, **kw):
        out = once(pv, cp, background, budget, *a, **kw)
        color = out.color.clone()
        color[color.shape[0] // 2:] = 0.0
        return out._replace(color=color)

    monkeypatch.setattr(render, "render_once", half)
    ok, numbers, _ = _run(check_from=4)
    assert "frames_missing" not in numbers
    assert not ok, numbers


def test_a_program_without_the_frame_entry_stops_at_set_up(monkeypatch):
    from reduced3dgs_torch import render
    from splatbench import scene

    made = []
    monkeypatch.delattr(render, "FrameServer")
    monkeypatch.setattr(scene, "primitives",
                        lambda *a, **kw: made.append(a))
    with pytest.raises(ImportError):
        _run()
    assert not made
