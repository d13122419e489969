"""Port parity: the transmittance statistics that feed SH-band culling
(K4's plain version and ``render(want_transmittance=True)``).

JAX runs on the CPU with its Pallas kernels in interpret mode, as
tests/test_tile_render.py runs them; the port runs on the CPU with the
plain versions of its kernels.  Tolerances, as
tests/test_tile_render.py:91-97 holds the Pallas kernel to the oracle:
``transmittance_sum`` atol 1e-3 / rtol 1e-3 (sums of up to a few thousand
f32 terms taken in another order), ``pixels_touched`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tile_render import BUDGET, H, W, make_scene

from reduced3dgs_torch import renderer as trenderer
from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_torch.ops import tile_render as ttr
from reduced3dgs_tpu import renderer as jrenderer
from reduced3dgs_tpu.cameras import Camera as JCamera

BG = np.array([0.2, 0.1, 0.4], np.float32)
EYE = (0.3, -0.2, -3.2)
TOL = dict(atol=1e-3, rtol=1e-3)
BACKENDS = {"tile": "pallas", "ref": "xla"}  # port backend -> JAX backend


def _scene_np(seed=0, n=300):
    return [np.array(a) for a in make_scene(seed=seed, n=n)]


def _jax_render(arrs, budget=BUDGET, backend="pallas", alive=None,
                grad_reduce="f32"):
    cam = JCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    return jrenderer.render(
        *(jnp.asarray(a) for a in arrs), cam.params(), jnp.asarray(BG),
        width=W, height=H, instance_budget=budget, backend=backend,
        want_transmittance=True, grad_reduce=grad_reduce,
        alive_mask=None if alive is None else jnp.asarray(alive))


def _port_render(arrs, budget=BUDGET, backend="tile", alive=None,
                 grad_reduce="f32"):
    cam = TCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    with torch.inference_mode():
        return trenderer.render(
            *(torch.as_tensor(a) for a in arrs), cam.params("cpu"),
            torch.as_tensor(BG), width=W, height=H, instance_budget=budget,
            backend=backend, want_transmittance=True,
            grad_reduce=grad_reduce,
            alive_mask=None if alive is None else torch.as_tensor(alive))


def _same_stats(got, want):
    np.testing.assert_allclose(got.transmittance_sum.numpy(),
                               np.asarray(want.transmittance_sum), **TOL)
    assert got.pixels_touched.dtype == torch.int32
    np.testing.assert_array_equal(got.pixels_touched.numpy(),
                                  np.asarray(want.pixels_touched))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_transmittance_matches_jax(backend):
    arrs = _scene_np()
    got = _port_render(arrs, backend=backend)
    want = _jax_render(arrs, backend=BACKENDS[backend])
    assert int(got.num_rendered) > 300
    assert int(got.pixels_touched.sum()) > 1000
    _same_stats(got, want)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               atol=2e-5, rtol=1e-4)


def test_tile_and_ref_agree_in_the_port():
    arrs = _scene_np(seed=3)
    a = _port_render(arrs, backend="tile")
    b = _port_render(arrs, backend="ref")
    np.testing.assert_allclose(a.transmittance_sum.numpy(),
                               b.transmittance_sum.numpy(), **TOL)
    assert torch.equal(a.pixels_touched, b.pixels_touched)


def test_bf16x2_mode_gives_the_f32_statistics():
    """K4 always reads the exact f32 feature table: the statistics do not
    depend on grad_reduce (bit for bit in the port, and equal to JAX's
    bf16x2 render at the stated tolerance)."""
    arrs = _scene_np()
    f32 = _port_render(arrs, grad_reduce="f32")
    fast = _port_render(arrs, grad_reduce="bf16x2")
    assert torch.equal(f32.transmittance_sum, fast.transmittance_sum)
    assert torch.equal(f32.pixels_touched, fast.pixels_touched)
    _same_stats(fast, _jax_render(arrs, grad_reduce="bf16x2"))


def test_dead_and_culled_rows_are_zero():
    arrs = _scene_np(seed=5)
    arrs[0][:20, 2] = -50.0  # behind the camera: culled by preprocess
    alive = np.ones(300, bool)
    alive[40:90] = False
    got = _port_render(arrs, alive=alive)
    want = _jax_render(arrs, alive=alive)
    _same_stats(got, want)
    off = np.r_[0:20, 40:90]
    assert not got.transmittance_sum.numpy()[off].any()
    assert not got.pixels_touched.numpy()[off].any()


def test_truncated_budget_matches_jax():
    """A budget below the true instance count: the walk stops at the
    truncated layout in both packages, and num_rendered reports it."""
    arrs = _scene_np()
    got = _port_render(arrs, budget=512)
    want = _jax_render(arrs, budget=512)
    assert int(got.num_rendered) > 512
    assert int(got.num_rendered) == int(want.num_rendered)
    _same_stats(got, want)


def _walk_inputs(arrs, budget=BUDGET):
    cam = TCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    a = [torch.as_tensor(x) for x in arrs]
    prep = tprep.preprocess(a[0], a[2], a[3], a[4], a[1], a[5],
                            cam.params("cpu"))
    b = tbin.bin_gaussians(prep, W, H, budget)
    src, ranges, limit, gx = ttr._walk_inputs(b, W, fast=False)
    return b, (src.table(), ranges, limit, gx)


def test_plain_k4_is_zero_off_the_walked_ranges():
    """Per slot: alignment slack inside a tile's range, padding, and
    everything past the last tile read exactly 0; the walked slots hold a
    count of at most 256 and a sum of at most the count."""
    b, (feat, ranges, limit, gx) = _walk_inputs(_scene_np())
    acc = ttr.tile_trans_plain(feat, ranges, limit, gx, W, H)
    assert acc.shape == (2, feat.shape[1]) and acc.dtype == torch.float32
    s = ranges[0].long()
    e = torch.minimum(ranges[1].long(), limit.long())
    walked = torch.zeros(feat.shape[1], dtype=torch.bool)
    for lo, hi in zip(s.tolist(), e.tolist()):
        walked[lo:hi] = True
    assert 0 < int(walked.sum()) < walked.numel()
    assert not acc[:, ~walked].any()
    assert not acc[:, b.pad_mask].any()
    assert float(acc[1].max()) <= ttr.NPIX
    assert bool((acc[0] <= acc[1] + 1e-6).all())  # every T is <= 1
    assert bool((acc[1] == acc[1].round()).all())


def test_plain_k4_matches_a_sequential_walk():
    """The kernel's loop (csrc/tile_trans.cu) written out per instance in
    numpy against the vectorised plain version: counts equal, sums within
    1e-5 (the same f32 terms in another order)."""
    _, (feat, ranges, limit, gx) = _walk_inputs(_scene_np(seed=2))
    acc = ttr.tile_trans_plain(feat, ranges, limit, gx, W, H).numpy()
    f = feat.numpy()
    pix = np.arange(ttr.NPIX)
    want = np.zeros_like(acc)
    for t in range(ranges.shape[1]):
        lo = int(ranges[0, t])
        hi = min(int(ranges[1, t]), int(limit))
        px = (t % gx) * 16 + pix % 16
        py = (t // gx) * 16 + pix // 16
        done = (px >= W) | (py >= H)
        big_t = np.ones(ttr.NPIX, np.float32)
        for j in range(lo, hi):
            dx = f[0, j] - px.astype(np.float32)
            dy = f[1, j] - py.astype(np.float32)
            power = (-0.5 * (f[2, j] * dx * dx + f[4, j] * dy * dy)
                     - f[3, j] * dx * dy).astype(np.float32)
            alpha = np.minimum(np.float32(0.99), f[5, j] * np.exp(
                np.minimum(power, 0))).astype(np.float32)
            live = ~done & (power <= ttr.POWER_EPS) & (alpha >= ttr.ALPHA_MIN)
            test_t = big_t * (1 - alpha)
            stop = live & (test_t < ttr.T_EPS)
            blend = live & ~stop
            want[0, j] = big_t[blend].sum()
            want[1, j] = blend.sum()
            big_t = np.where(blend, test_t, big_t)
            done |= stop
    np.testing.assert_array_equal(acc[1], want[1])
    np.testing.assert_allclose(acc[0], want[0], atol=1e-5, rtol=1e-5)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The dispatch is by the tensor's device alone: a CUDA tensor goes to
    the kernel's wrapper (which raises where it cannot build or launch),
    never to the plain version."""
    calls = []
    monkeypatch.setattr(ttr, "_tile_trans_cuda",
                        lambda *a: calls.append("cuda"))
    monkeypatch.setattr(ttr, "tile_trans_plain",
                        lambda *a: calls.append("plain"))

    class Fake:
        def __init__(self, kind):
            self.device = torch.device(kind)

        def table(self):
            return self

    ttr.tile_trans(Fake("cuda"), None, None, 1, 16, 16)
    ttr.tile_trans(Fake("cpu"), None, None, 1, 16, 16)
    assert calls == ["cuda", "plain"]
    with pytest.raises(ValueError):
        ttr.tile_trans(Fake("meta"), None, None, 1, 16, 16)
    assert "tile_trans" in ttr._cuda.SOURCES
