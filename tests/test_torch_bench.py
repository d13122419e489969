"""The port's benchmark (reduced3dgs_torch/bench.py) against root bench.py
on the CPU, at a tiny configuration.

Root bench.py's _measure draws its scene from default_rng(0) inline; the
test stops it at its camera (after the draws) and takes the arrays from
its frame, so the port is held to root's own code.  The port's step must
give the JAX render's num_rendered and loss (backend "pallas", interpret
mode here, bf16x2) within the render tolerance, and a child process at
the tiny configuration must print a line with root bench.py's keys.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as root_bench
from reduced3dgs_torch import bench
from reduced3dgs_tpu import cameras as jcameras
from reduced3dgs_tpu.renderer import render as jrender

TINY = (64, 48, 1500, (0.02, 0.08), 1 << 14, "tiny")
ROOT_KEYS = {"metric", "value", "unit", "vs_baseline", "num_rendered",
             "instances_per_s"}


class _Stop(Exception):
    pass


def _root_arrays(monkeypatch, n, smin, smax):
    """The arrays root bench.py's _measure draws, from its frame."""
    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(jcameras.Camera, "look_at", stop)
    with pytest.raises(_Stop) as info:
        root_bench._measure(64, 48, n, smin, smax, 1 << 14)
    tb = info.tb
    while tb.tb_frame.f_code.co_name != "_measure":
        tb = tb.tb_next
    f = tb.tb_frame.f_locals
    return tuple(f[k] for k in ("xyz", "feats", "scales", "rots", "opac",
                                "degrees"))


def test_arrays_are_root_bench_draws(monkeypatch):
    for n, (smin, smax) in ((TINY[2], TINY[3]), (4096, (0.00432, 0.0189))):
        want = _root_arrays(monkeypatch, n, smin, smax)
        got = bench.bench_arrays(n, smin, smax)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert bench.CONFIGS == root_bench.CONFIGS
    assert bench.REF_PIXELS_PER_S == root_bench.REF_PIXELS_PER_S


def test_step_matches_jax_render():
    width, height, n, (smin, smax), budget, _ = TINY
    fb = bench.FwdBwd(width, height, n, smin, smax, budget, "cpu")
    loss, nr, grads = fb.step()
    xyz, feats, scales, rots, opac, degrees = bench.bench_arrays(
        n, smin, smax)
    cp = jcameras.Camera.look_at(eye=(0, 0, -3.6), target=(0, 0, 0),
                                 width=width, height=height).params()
    out = jrender(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(scales),
                  jnp.asarray(rots), jnp.asarray(opac), degrees, cp,
                  np.zeros(3, np.float32), width=width, height=height,
                  instance_budget=budget, backend="pallas",
                  grad_reduce="bf16x2")
    want = float(jnp.abs(out.color).mean())
    assert int(nr) == int(out.num_rendered) > 0
    np.testing.assert_allclose(float(loss), want, atol=2e-5, rtol=1e-4)
    assert [g.shape for g in grads] == [l.shape for l in fb.leaves]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # the loop the CPU times: the same step, eagerly
    run = fb.runner()
    run.replay()
    assert torch.equal(run.out[0], loss) and int(run.out[1]) == int(nr)


def test_child_prints_root_keys(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    line = bench.run_config(TINY, "cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == ROOT_KEYS | {"device"} and line["device"] == "cpu"
    assert line["metric"] == "raster_fwd_bwd_tiny"
    assert line["unit"] == "pixels/s/chip" and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.REF_PIXELS_PER_S, 4)
    fb = bench.FwdBwd(*TINY[:3], *TINY[3], TINY[4], "cpu")
    assert line["num_rendered"] == int(fb.step()[1])
