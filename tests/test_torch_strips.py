"""Strip rendering of the multi-device path, torch against JAX: binning and
the tile renderer on a window of tile rows, and the SSIM band sum.

* bin_gaussians(tile_rows=) / padded_size(tile_rows=): every BinningOut
  field bit-identical to the JAX package's, on strips (0, 1), (1, 2) and
  one past the last tile row, and on the budget-truncated binning cases;
* tile_render(tile_rows=): the image and the gradients of the four
  differentiable inputs against the JAX tile_render(tile_rows=) (Pallas
  in interpret mode) at atol 2e-5 / rtol 1e-4 (gradients at the render
  tolerance of tests/test_torch_grad.py); the final T at atol 2e-5 /
  rtol 1e-4 against the JAX package's XLA oracle (render_ref) on the
  strip's rows, which the port's T matches to ~1e-6 (the Pallas kernel's
  log-space T was once seen 6e-5 off it in one test process, and never
  again in a dozen runs);
* the strips stitched equal the full frame (each tile walks the same
  instances in the same order), their gradients summed equal the full
  frame's, and the per-primitive transmittance statistics of the strips
  add up to the full frame's;
* ssim_band_sum over a row cover against the JAX package's at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tile_render import BUDGET, H, W, make_scene
from test_torch_binning import CASES, _slack_prep

from reduced3dgs_torch import renderer as trenderer
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import losses as tloss
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_torch.ops import tile_render as ttr
from reduced3dgs_torch.ops.preprocess import tile_grid
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.ops import binning as jbin
from reduced3dgs_tpu.ops import losses as jloss
from reduced3dgs_tpu.ops import preprocess as jprep
from reduced3dgs_tpu.ops import render_ref as jref
from reduced3dgs_tpu.ops import tile_render as jtr

BG = np.array([0.2, 0.1, 0.4], np.float32)
EYE = (0.3, -0.2, -3.2)
TOL = dict(atol=2e-5, rtol=1e-4)
GY = tile_grid(W, H)[1]  # 3 tile rows of 16 for 40 pixel rows
STRIPS = [(0, 1), (1, 2), (GY, 1)]
DIFF = ("means2d", "conic", "opacity", "color")


@pytest.fixture(scope="module")
def prep_np():
    xyz, feats, scales, rots, opac, deg = make_scene()
    cam = JCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    prep = jprep.preprocess(xyz, scales, rots, opac, feats, deg,
                            cam.params())
    return jprep.PreprocessOut(*(np.asarray(a) for a in prep))


def _tprep(prep_np, grad=False):
    t = {k: torch.as_tensor(v).clone() for k, v in prep_np._asdict().items()}
    if grad:
        for k in DIFF:
            t[k].requires_grad_(True)
    return tprep.PreprocessOut(**t)


def _bin_equal(want, got):
    for field in want._fields:
        a = np.asarray(getattr(want, field))
        b = getattr(got, field).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)


@pytest.mark.parametrize("tile_rows", STRIPS)
def test_strip_binning_bit_identical(prep_np, tile_rows):
    jp = jprep.PreprocessOut(*(jnp.asarray(a) for a in prep_np))
    want = jbin.bin_gaussians(jp, W, H, BUDGET, tile_rows=tile_rows)
    got = tbin.bin_gaussians(_tprep(prep_np), W, H, BUDGET,
                             tile_rows=tile_rows)
    _bin_equal(want, got)
    assert got.tile_ranges.shape[1] == tile_rows[1] * tile_grid(W, H)[0]
    if tile_rows[0] >= GY:  # past the image: no instance
        assert int(got.num_rendered) == 0
    else:
        assert int(got.num_rendered) > 50


@pytest.mark.parametrize("name", ["synthetic_truncated", "scene_overflow",
                                  "slack_overflow"])
def test_strip_binning_of_the_truncated_cases(name):
    """The budget-truncation and slack-overflow cases of
    tests/test_torch_binning.py, binned as the middle strip of their
    frame.  The slack-overflow strip needs more pads than its slack pool
    but fits in its B_pad: the port lays the pads that the JAX package
    drops into the budget's unused slots, so there the two layouts of
    the slots differ and everything else is bit for bit."""
    build, width, height, budget = CASES[name]
    prep = jprep.PreprocessOut(*(np.asarray(a) for a in build()))
    gy = tile_grid(width, height)[1]
    tile_rows = (gy // 3, gy - 2 * (gy // 3))
    want = jbin.bin_gaussians(
        jprep.PreprocessOut(*(jnp.asarray(a) for a in prep)), width, height,
        budget, tile_rows=tile_rows)
    got = tbin.bin_gaussians(
        tprep.PreprocessOut(*(torch.as_tensor(a) for a in prep)), width,
        height, budget, tile_rows=tile_rows)
    if name != "slack_overflow":
        _bin_equal(want, got)
        return
    b_pad, nv = got.gauss_aligned.shape[0], int(got.num_rendered)
    assert nv + (b_pad - budget) < int(got.total_padded) <= b_pad
    laid_out = ("gauss_aligned", "tile_id")
    _bin_equal(
        want._replace(**dict.fromkeys(laid_out, np.zeros(1, np.int32))),
        got._replace(**dict.fromkeys(laid_out,
                                     torch.zeros(1, dtype=torch.int32))))
    # every tile whole: its instances, the JAX package's, from its range's
    # start, then its pads up to the next multiple of 128; unused after
    start, end = got.tile_ranges.long()
    tile = torch.full((b_pad,), start.shape[0], dtype=torch.long)
    inst = torch.zeros(b_pad, dtype=torch.bool)
    for t, (s0, e0) in enumerate(zip(start.tolist(), end.tolist())):
        tile[s0:-(-e0 // 128) * 128] = t
        inst[s0:e0] = True
    assert torch.equal(got.tile_id.long(), tile)
    assert torch.equal(~got.pad_mask, inst)

    def pairs(b):
        ids = np.asarray(b.gauss_aligned)
        keep = ids != np.iinfo(np.int32).max
        return sorted(zip(np.asarray(b.tile_id)[keep].tolist(),
                          ids[keep].tolist()))

    assert pairs(got) == pairs(want)


def test_padded_size_of_a_strip_matches_jax():
    for w, h, b, rows in [(56, 40, 4096, (1, 2)), (1920, 1080, 1 << 22,
                                                   (17, 17)),
                          (512, 512, 3 << 18, (0, 8)), (128, 128, 100,
                                                        (7, 1))]:
        assert (tbin.padded_size(b, w, h, tile_rows=rows)
                == jbin.padded_size(b, w, h, tile_rows=rows))


def _jax_oracle_t(prep_np, tile_rows):
    """The JAX oracle's final T on the strip's rows (1 past the image)."""
    jp = jprep.PreprocessOut(*(jnp.asarray(a) for a in prep_np))
    t = np.asarray(jref.render_ref(jp, jbin.bin_gaussians(jp, W, H, BUDGET),
                                   jnp.asarray(BG), W, H)[1])
    r0, rows = tile_rows
    t = np.concatenate([t, np.ones(((r0 + rows) * 16, W), np.float32)])
    return t[r0 * 16:(r0 + rows) * 16]


def _jax_strip(prep_np, tile_rows, cot):
    jp = jprep.PreprocessOut(*(jnp.asarray(a) for a in prep_np))
    jb = jbin.bin_gaussians(jp, W, H, BUDGET, tile_rows=tile_rows)

    def f(m, c, o, col):
        p = jp._replace(means2d=m, conic=c, opacity=o, color=col)
        color, t_fin, _, _ = jtr.tile_render(p, jb, jnp.asarray(BG), W, H,
                                             tile_rows=tile_rows)
        return (color * cot).sum(), (color, t_fin)

    grads, (color, t_fin) = jax.grad(f, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        *(getattr(jp, k) for k in DIFF))
    return color, t_fin, grads


def _torch_strip(prep_np, tile_rows, cot, grad_reduce="f32"):
    tp = _tprep(prep_np, grad=True)
    tb = tbin.bin_gaussians(tp, W, H, BUDGET, tile_rows=tile_rows)
    color, t_fin, _, _ = ttr.tile_render(tp, tb, torch.as_tensor(BG), W, H,
                                         tile_rows=tile_rows,
                                         grad_reduce=grad_reduce)
    grads = torch.autograd.grad((color * torch.as_tensor(cot)).sum(),
                                [getattr(tp, k) for k in DIFF])
    return color.detach(), t_fin.detach(), grads


def _cot(rows, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (rows * 16, W, 3)).astype(np.float32)


@pytest.mark.parametrize("tile_rows", STRIPS)
def test_strip_render_and_gradients_match_jax(prep_np, tile_rows):
    cot = _cot(tile_rows[1], tile_rows[0])
    want_c, want_t, want_g = _jax_strip(prep_np, tile_rows, cot)
    got_c, got_t, got_g = _torch_strip(prep_np, tile_rows, cot)
    assert got_c.shape == (tile_rows[1] * 16, W, 3)
    assert got_t.shape == np.asarray(want_t).shape
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_t.numpy(),
                               _jax_oracle_t(prep_np, tile_rows), **TOL)
    # rows past the image height are background with T = 1
    below = min(tile_rows[1] * 16,
                max(0, (tile_rows[0] + tile_rows[1]) * 16 - H))
    if below:
        assert bool((got_t[-below:] == 1.0).all())
        assert torch.equal(got_c[-below:],
                           torch.as_tensor(BG).expand(below, W, 3))
    for k, a, b in zip(DIFF, want_g, got_g):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=2e-3, atol=2e-4 * max(np.abs(a).max(), 1e-9),
            err_msg=k)


@pytest.mark.parametrize("grad_reduce", ["f32", "bf16x2"])
def test_strips_stitch_to_the_full_frame(prep_np, grad_reduce):
    """Strips of 2 + 1 tile rows stitched: the full frame's pixels and,
    under the full frame's cotangent, its per-primitive gradients summed
    over the strips; the strips' transmittance statistics add up."""
    cot = _cot(GY, 7)[:H]
    full_c, full_t, full_g = _torch_strip(prep_np, None, cot, grad_reduce)
    pieces, sums = [], None
    for r0, rows in ((0, 2), (2, 2)):  # the last strip reaches past H
        c = np.zeros((rows * 16, W, 3), np.float32)
        c[:max(0, min(rows * 16, H - r0 * 16))] = cot[r0 * 16:(r0 + rows)
                                                      * 16]
        col, t_fin, g = _torch_strip(prep_np, (r0, rows), c, grad_reduce)
        pieces.append((col, t_fin))
        sums = list(g) if sums is None else [s + x for s, x in zip(sums, g)]
    color = torch.cat([p[0] for p in pieces])[:H]
    t_fin = torch.cat([p[1] for p in pieces])[:H]
    assert torch.equal(color, full_c) and torch.equal(t_fin, full_t)
    for k, a, b in zip(DIFF, full_g, sums):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3,
                                   atol=2e-4 * float(a.abs().max()),
                                   err_msg=k)
    tp = _tprep(prep_np)
    full = ttr.transmittance_by_primitive(
        tbin.bin_gaussians(tp, W, H, BUDGET), W, H)
    gx = tile_grid(W, H)[0]
    parts = [ttr.transmittance_by_primitive(
        tbin.bin_gaussians(tp, W, H, BUDGET, tile_rows=(r0, rows)), W, H,
        base=r0 * gx) for r0, rows in ((0, 2), (2, 2))]
    assert torch.equal(parts[0][1] + parts[1][1], full[1])
    np.testing.assert_allclose((parts[0][0] + parts[1][0]).numpy(),
                               full[0].numpy(), rtol=1e-5, atol=1e-5)
    assert int(full[1].sum()) > 1000


def test_renderer_strip_arguments(prep_np):
    """renderer.render(strip_r0=, strip_rows=) renders the strip of the
    tile backend, with its demand as num_rendered; "ref" refuses."""
    xyz, feats, scales, rots, opac, deg = (torch.as_tensor(np.asarray(a))
                                           for a in make_scene())
    from reduced3dgs_torch.cameras import Camera

    cp = Camera.look_at(eye=EYE, target=(0, 0, 0), width=W,
                        height=H).params("cpu")
    args = (xyz, feats, scales, rots, opac, deg, cp, torch.as_tensor(BG))
    with torch.no_grad():
        full = trenderer.render(*args, width=W, height=H,
                                instance_budget=BUDGET)
        strip = trenderer.render(*args, width=W, height=H,
                                 instance_budget=BUDGET, strip_r0=1,
                                 strip_rows=2)
    assert strip.color.shape == (32, W, 3)
    assert torch.equal(strip.color[:H - 16], full.color[16:])
    assert 0 < int(strip.num_rendered) < int(full.num_rendered)
    with pytest.raises(NotImplementedError):
        trenderer.render(*args, width=W, height=H, instance_budget=BUDGET,
                         backend="ref", strip_r0=0, strip_rows=1)


@pytest.mark.parametrize("tile_rows,report", [((2, 4), 129), ((1, 2), 32)])
def test_overflow_report_of_a_strip_equals_the_renders(tile_rows, report,
                                                       monkeypatch):
    """renderer.overflow_report, the sharded step's strip demand, equals
    what render() reports for the strip: one splat a tile of a 16x8 grid
    at budget 128, whose strip (2, 4) holds 64 instances and 8,192
    aligned slots against 7,168 (past the budget), strip (1, 2) 4,096
    against 4,096 (whole: its true count)."""
    prep = tprep.PreprocessOut(*(torch.as_tensor(a)
                                 for a in _slack_prep(16, 8)))
    b = tbin.bin_gaussians(prep, 256, 128, 128, tile_rows=tile_rows)
    assert int(b.num_rendered) <= 128
    assert int(trenderer.overflow_report(b, 128)) == report
    monkeypatch.setattr(tprep, "preprocess", lambda *a, **k: prep)
    from reduced3dgs_torch.cameras import Camera

    cp = Camera.look_at(eye=EYE, target=(0, 0, 0), width=256,
                        height=128).params("cpu")
    with torch.no_grad():
        out = trenderer.render(*(None,) * 6, cp, torch.as_tensor(BG),
                               width=256, height=128, instance_budget=128,
                               strip_r0=tile_rows[0],
                               strip_rows=tile_rows[1])
    assert int(out.num_rendered) == report


def test_ssim_band_sum_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (45, 37, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta = torch.as_tensor(a).requires_grad_(True)
    tb = torch.as_tensor(b)
    band = 12  # a cover of 4 bands, the last reaching past the image
    total = 0.0
    for s0 in range(0, 48, band):
        got = tloss.ssim_band_sum(ta, tb, s0, band)
        want = jloss.ssim_band_sum(jnp.asarray(a), jnp.asarray(b), s0, band)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        total = total + got
    np.testing.assert_allclose(float(total) / a.size,
                               float(tloss.ssim(ta, tb)), rtol=1e-6)
    (g,) = torch.autograd.grad(total / a.size, [ta])
    (g_full,) = torch.autograd.grad(tloss.ssim(ta, tb), [ta])
    np.testing.assert_allclose(g.numpy(), g_full.numpy(), rtol=1e-5,
                               atol=1e-5 * float(g_full.abs().max()))
