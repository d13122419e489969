"""`correct` at small sizes on the CPU: the program's plain versions
against the reference come out correct; the control (the reference in
bfloat16 in the program's place) and each fault planted under a run come
out not correct, with the cells' own limits."""

import pytest
import torch

from splatbench import calibrate, judge, run
from splatbench.tests import tiny

CPU = torch.device("cpu")
TRAIN = ("m360_full_dense.train", "tnt_reduced_dense.train")
VIEW = ("tnt_reduced_dense.view", "m360_full_dense.view")


def _run(name, seed=7, seconds=1.0, **traffic):
    """One small run on the CPU; a viewing window lasts long enough to
    render every kept pose (those among the first `check_from`)."""
    bench = run.Bench()
    cell = bench.cell(name)
    tr = tiny.traffic(bench.traffic(cell)["generator"], **traffic)
    out = run.measure(bench, cell, seed, seconds, False, CPU,
                      cfg=tiny.config(cell["config"]), traffic=tr)
    ok, rows = judge.verdict(out.numbers, bench.limits(cell))
    return ok, dict((n, v) for n, v, _ in rows), out


@pytest.mark.parametrize("name", TRAIN + VIEW)
def test_the_program_is_correct_at_a_small_size(name):
    kw = {} if name in TRAIN else {"check_from": 2}
    ok, numbers, out = _run(name, seed=2 ** 31 + 11, **kw)
    assert ok, numbers
    assert out.attempted > 0 and out.e2e


@pytest.mark.parametrize("name", TRAIN + VIEW)
def test_the_control_is_not_correct(name):
    bench = run.Bench()
    cell = bench.cell(name)
    cfg = tiny.config(cell["config"])
    traffic = tiny.traffic(bench.traffic(cell)["generator"])
    read = (calibrate._train_readings if name in TRAIN
            else calibrate._view_readings)
    readings = read(cfg, traffic, 5, CPU)
    limits = bench.limits(cell)
    for kind, numbers in readings.items():
        ok, _ = judge.verdict(numbers, limits)
        assert not ok, (kind, numbers)


def _unchanged_state(monkeypatch):
    from reduced3dgs_torch.train import trainer

    step = trainer.fused_step

    def kept(buf, **kw):
        saved = [t.clone() for t in buf.carried]
        step(buf, **kw)
        for t, s in zip(buf.carried, saved):
            t.copy_(s)

    monkeypatch.setattr(trainer, "fused_step", kept)


def _half_batch(monkeypatch):
    from reduced3dgs_torch.train import trainer

    l1, ssim = trainer.l1_loss, trainer.ssim

    def top(f):
        return lambda a, b: f(a[: a.shape[0] // 2], b[: b.shape[0] // 2])

    monkeypatch.setattr(trainer, "l1_loss", top(l1))
    monkeypatch.setattr(trainer, "ssim", top(ssim))


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_a_training_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    ok, numbers, _ = _run(name)
    assert not ok, numbers


def _frame_fault(monkeypatch, change):
    from reduced3dgs_torch import render

    once = render.render_once

    def broken(pv, cp, background, budget, *a, **kw):
        out = once(pv, cp, background, budget, *a, **kw)
        return out._replace(color=change(out.color, cp))

    monkeypatch.setattr(render, "render_once", broken)


def _stale_frame(monkeypatch):
    """Every frame shows the path's first pose, whatever the pose."""
    from splatbench.generators import view

    copy = view.View.frame

    def frame(self, keep=False):
        self.host = self.host[:1].expand_as(self.host)
        return copy(self, keep)

    monkeypatch.setattr(view.View, "frame", frame)


def _half_frame(monkeypatch):
    def cut(c, cp):
        c = c.clone()
        c[c.shape[0] // 2:] = 0.0
        return c

    _frame_fault(monkeypatch, cut)


def _altered_answer(monkeypatch):
    def alter(c, cp):
        c = c.clone()
        c[:8, :8] += 0.5
        return c

    _frame_fault(monkeypatch, alter)


@pytest.mark.parametrize("name", VIEW)
@pytest.mark.parametrize("fault", [_stale_frame, _half_frame,
                                   _altered_answer])
def test_a_viewing_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    ok, numbers, _ = _run(name, check_from=4)
    assert "frames_missing" not in numbers  # judged on rendered frames
    assert not ok, numbers
