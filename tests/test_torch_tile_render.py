"""Port parity: the tile forward (K2 plain version) and the whole render.

JAX runs on the CPU with its Pallas kernels in interpret mode, as
tests/test_tile_render.py runs them; the port runs on the CPU with the
plain versions of K1/K2.  Colour and final T must agree to atol 2e-5 /
rtol 1e-4 (the tolerance tests/test_tile_render.py:63 holds the Pallas
kernel to against the oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tile_render import BUDGET, H, W, make_scene

from reduced3dgs_torch import renderer as trenderer
from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.models.gaussians import pool_from_numpy
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_torch.ops import tile_render as ttr
from reduced3dgs_tpu import renderer as jrenderer
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.models.ply_io import pool_from_arrays as jpool_from_arrays
from reduced3dgs_tpu.ops import binning as jbin
from reduced3dgs_tpu.ops import preprocess as jprep
from reduced3dgs_tpu.ops import tile_render as jtr

BG = np.array([0.2, 0.1, 0.4], np.float32)
EYE = (0.3, -0.2, -3.2)
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_prep():
    xyz, feats, scales, rots, opac, deg = make_scene()
    cam = JCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    prep = jprep.preprocess(xyz, scales, rots, opac, feats, deg,
                            cam.params())
    return jprep.PreprocessOut(*(np.asarray(a) for a in prep))


def test_tile_render_forward_matches_jax(jax_prep):
    jp = jprep.PreprocessOut(*(jnp.asarray(a) for a in jax_prep))
    jb = jbin.bin_gaussians(jp, W, H, BUDGET)
    want_c, want_t, _, _ = jtr.tile_render(jp, jb, jnp.asarray(BG), W, H)
    tp = tprep.PreprocessOut(*(torch.as_tensor(a) for a in jax_prep))
    tb = tbin.bin_gaussians(tp, W, H, BUDGET)
    got_c, got_t, g_trans, g_touch = ttr.tile_render(
        tp, tb, torch.as_tensor(BG), W, H)
    assert int(tb.num_rendered) > 300  # multi-tile coverage, >1 chunk
    assert g_trans is None and g_touch is None
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)


def test_packed_tiles_match_jax_kernel_output(jax_prep):
    """K2's plain version against the JAX _fwd_kernel output rows
    (T, 8, 256), including the empty-tile rows (colour 0, T 1) and the
    cropped edge pixels."""
    jp = jprep.PreprocessOut(*(jnp.asarray(a) for a in jax_prep))
    jb = jbin.bin_gaussians(jp, W, H, BUDGET)
    want, _ = jtr._core_fwd(jp.means2d, jp.conic, jp.opacity, jp.color, jb,
                            jnp.zeros((1,), jnp.int32), W, H, 3)
    tp = tprep.PreprocessOut(*(torch.as_tensor(a) for a in jax_prep))
    tb = tbin.bin_gaussians(tp, W, H, BUDGET)
    got = ttr._core_fwd(tb, W, H)
    assert got.shape == (12, ttr.PIX_ROWS, ttr.NPIX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _sequential_walk(feat, ranges, limit, grid_x):
    """K2's body (csrc/tile_fwd.cu) as a per-instance loop, vectorised over
    the 256 pixels of a tile only: the packed output and the pair counts
    the operation bound rests on."""
    f = feat.numpy()
    r = ranges.numpy()
    pix = np.arange(ttr.NPIX)
    out = np.zeros((r.shape[1], ttr.PIX_ROWS, ttr.NPIX), np.float32)
    pairs = dict(walked=0, blended=0, stopped=0)
    for t in range(r.shape[1]):
        px = (t % grid_x * 16 + pix % 16).astype(np.float32)
        py = (t // grid_x * 16 + pix // 16).astype(np.float32)
        done = (px >= W) | (py >= H)
        tt = np.ones(ttr.NPIX, np.float32)
        col = np.zeros((3, ttr.NPIX), np.float32)
        for j in range(r[0, t], min(r[1, t], int(limit))):
            x, y, cxx, cxy, cyy, op = f[:6, j]
            dx, dy = x - px, y - py
            power = (np.float32(-0.5) * (cxx * dx * dx + cyy * dy * dy)
                     - cxy * dx * dy)
            alpha = np.minimum(np.float32(ttr.ALPHA_CLAMP),
                               op * np.exp(np.minimum(power, 0)))
            live = ~done & (power <= ttr.POWER_EPS) & (alpha >= ttr.ALPHA_MIN)
            test_t = tt * (1 - alpha)
            stop = live & (test_t < ttr.T_EPS)
            blend = live & ~stop
            pairs["walked"] += int((~done).sum())
            pairs["blended"] += int(blend.sum())
            pairs["stopped"] += int(stop.sum())
            col += np.where(blend, alpha * tt, 0) * f[6:9, j, None]
            tt = np.where(blend, test_t, tt)
            done |= stop
        out[t, 0:3], out[t, 3] = col, tt
    return out, pairs


def test_plain_forward_counts_walked_pairs(jax_prep, monkeypatch):
    """The plain version against K2's sequential walk: the output to TOL,
    and the walked / blended / stopped pair counts (threshold flips from
    the cumulative product's rounding allowed on 1 % of them).  The tile
    group is cut to 5 so that the 12 tiles take several groups."""
    tp = tprep.PreprocessOut(*(torch.as_tensor(a) for a in jax_prep))
    tb = tbin.bin_gaussians(tp, W, H, BUDGET)
    feat, b_pad = ttr._pack_features(tb)
    limit = torch.clamp(tb.total_padded, max=b_pad)
    whole = ttr.tile_fwd_plain(feat, tb.tile_ranges, limit, 4, W, H)
    monkeypatch.setattr(ttr, "TILE_GROUP", 5)
    out, pairs = ttr.tile_fwd_plain(feat, tb.tile_ranges, limit, 4, W, H,
                                    count_pairs=True)
    np.testing.assert_array_equal(out.numpy(), whole.numpy())
    want, want_pairs = _sequential_walk(feat, tb.tile_ranges, limit, 4)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    assert 0 < pairs["stopped"] < pairs["blended"] < pairs["walked"]
    for k, v in want_pairs.items():
        assert abs(pairs[k] - v) <= 0.01 * v, (k, pairs[k], v)


def _hand_case():
    """One 16x16 tile, eight staged instances.  Instance 0 is a small
    splat at pixel (1, 1): alpha 0.5 there, 0.5 e^-4 on its four
    neighbours, below 1/255 elsewhere.  Instances 1..7 are flat layers of
    alpha 0.95 over the whole tile: T runs 0.05, 0.0025, 1.25e-4 and would
    fall to 6.25e-6, so a pixel stops at the fourth layer (index 4), and
    pixel (1, 1), whose T starts at 0.5, at the third (index 3)."""
    feat = torch.zeros((9, 128))
    feat[:, 0] = torch.tensor([1.0, 1.0, 8.0, 0.0, 8.0, 0.5, 1.0, 0.5, 0.2])
    feat[5, 1:8] = 0.95
    feat[6:9, 1:8] = 0.3
    ranges = torch.tensor([[0], [128]], dtype=torch.int32)
    return feat, ranges, torch.tensor(8, dtype=torch.int32)


@pytest.mark.parametrize("warp_shape,inst0_warps", [((8, 4), 1),
                                                    ((16, 2), 2),
                                                    ((4, 8), 1)])
def test_warp_counts_hand_checked(warp_shape, inst0_warps):
    """The (warp, instance) counts on a case counted by hand: the five
    pixels that blend instance 0 lie in rows 0..2, columns 0..2, one warp
    of 8x4 or 4x8 pixels and two warps of two 16-pixel rows."""
    feat, ranges, limit = _hand_case()
    _, pairs = ttr.tile_fwd_plain(feat, ranges, limit, 1, 16, 16,
                                  count_pairs=True, warp_shape=warp_shape)
    assert pairs["walked"] == 4 + 255 * 5
    assert pairs["blended"] == 3 + 4 * 4 + 251 * 3
    assert pairs["stopped"] == 256
    assert pairs["warp_walked"] == 8 * 5  # every warp walks to index 4
    assert pairs["warp_blended"] == inst0_warps + 3 * 8
    assert pairs["staged"] == 8  # one batch of 128, cut by the limit
    for batch, staged in ((2, 6), (4, 8), (64, 8)):
        _, p = ttr.tile_fwd_plain(feat, ranges, limit, 1, 16, 16,
                                  count_pairs=True, warp_shape=warp_shape,
                                  batch=batch)
        assert p["staged"] == staged and p["walked"] == pairs["walked"]
    with pytest.raises(ValueError, match="divide"):
        ttr.tile_fwd_plain(feat, ranges, limit, 1, 16, 16, batch=48)


@pytest.mark.parametrize("ppt,shape,inst0_warps", [
    (2, (8, 4), 1),   # 16x4 strips: rows 0..2 lie in the first
    (2, (16, 2), 1),  # four rows a warp
    (4, (16, 2), 1),  # eight rows a warp
    (4, (8, 4), 1),   # 16x8 halves
    (2, (4, 8), 1),   # 8x8 quarters
])
def test_warp_counts_with_several_pixels_per_thread(ppt, shape, inst0_warps):
    """A thread that owns ppt pixels makes warps of 32 ppt pixels: 8 / ppt
    warps walk the hand-counted case, the pixel counts stay."""
    feat, ranges, limit = _hand_case()
    _, pairs = ttr.tile_fwd_plain(feat, ranges, limit, 1, 16, 16,
                                  count_pairs=True, warp_shape=shape,
                                  pixels_per_thread=ppt)
    warps = 8 // ppt
    assert pairs["walked"] == 4 + 255 * 5 and pairs["stopped"] == 256
    assert pairs["warp_walked"] == warps * 5
    assert pairs["warp_blended"] == inst0_warps + 3 * warps
    assert pairs["walked"] <= 32 * ppt * pairs["warp_walked"]


@pytest.mark.parametrize("warp_shape", [(8, 4), (16, 2), (4, 8)])
def test_warp_count_invariants(jax_prep, warp_shape):
    tp = tprep.PreprocessOut(*(torch.as_tensor(a) for a in jax_prep))
    tb = tbin.bin_gaussians(tp, W, H, BUDGET)
    feat, b_pad = ttr._pack_features(tb)
    limit = torch.clamp(tb.total_padded, max=b_pad)
    _, p = ttr.tile_fwd_plain(feat, tb.tile_ranges, limit, 4, W, H,
                              count_pairs=True, warp_shape=warp_shape)
    assert 0 < p["walked"] <= 32 * p["warp_walked"]
    assert 0 < p["blended"] <= 32 * p["warp_blended"]
    assert p["warp_blended"] <= p["warp_walked"]
    inst = int((tb.tile_ranges[1] - tb.tile_ranges[0]).sum())
    _, p32 = ttr.tile_fwd_plain(feat, tb.tile_ranges, limit, 4, W, H,
                                count_pairs=True, warp_shape=warp_shape,
                                batch=32)
    # a warp walks no further than its block stages, a smaller batch
    # stages no more, and nothing past the ranges
    assert p["warp_walked"] <= 8 * p32["staged"] <= 8 * p["staged"]
    assert p["staged"] <= inst


def test_warp_pixels_cover_the_tile():
    for shape in ((8, 4), (16, 2), (4, 8)):
        wp = ttr.warp_pixels(shape)
        assert wp.shape == (8, 32)
        assert sorted(wp.flatten().tolist()) == list(range(256))
        xs, ys = wp[3] % 16, wp[3] // 16
        assert int(xs.max() - xs.min()) == shape[0] - 1
        assert int(ys.max() - ys.min()) == shape[1] - 1
    # two 16-pixel rows: the thread index is the pixel
    assert ttr.warp_pixels((16, 2)).flatten().tolist() == list(range(256))
    with pytest.raises(ValueError):
        ttr.warp_pixels((32, 1))
    # two pixels per thread on 8x4 blocks: a warp is a 16x4 strip, and a
    # thread's second pixel lies 8 to the right of its first
    wp = ttr.warp_pixels((8, 4), 2)
    assert wp.shape == (4, 64)
    assert sorted(wp[1].tolist()) == list(range(64, 128))
    assert (wp[:, 32:] - wp[:, :32] == 8).all()
    # four per thread: 16x8 halves, pixels 2 and 3 four rows below
    wp = ttr.warp_pixels((8, 4), 4)
    assert wp.shape == (2, 128) and (wp[:, 64:] - wp[:, :64] == 64).all()
    with pytest.raises(ValueError):
        ttr.warp_pixels((8, 4), 3)


def _jax_pool(seed=0):
    xyz, feats, scales, rots, opac, deg = (np.asarray(a)
                                           for a in make_scene(seed))
    return jpool_from_arrays({
        "xyz": xyz, "features_dc": feats[:, :1], "features_rest": feats[:, 1:],
        "opacity": opac[:, None], "scaling": scales, "rotation": rots,
        "degrees": deg})


def _leaves(pool):
    p = pool.params
    return {"xyz": p.xyz, "features_dc": p.features_dc,
            "features_rest": p.features_rest, "scaling": p.scaling,
            "rotation": p.rotation, "opacity": p.opacity,
            "degrees": pool.degrees, "alive": pool.alive}


@pytest.mark.parametrize("backend,budget", [("pallas", BUDGET),
                                            ("pallas", 256),
                                            ("xla", BUDGET)])
def test_render_matches_jax(backend, budget):
    """The whole render on a pool carried across by pool_from_numpy
    (capacity-padded, with dead slots), incl. a truncating budget."""
    jpool = _jax_pool()
    leaves = {k: np.asarray(v) for k, v in _leaves(jpool).items()}
    tpool = pool_from_numpy(leaves, "cpu")
    assert tpool.capacity == jpool.capacity > int(leaves["alive"].sum())
    jcam = JCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    tcam = TCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H)
    want = jrenderer.render(
        jpool.params.xyz, jpool.features(), jpool.params.scaling,
        jpool.params.rotation, jpool.params.opacity[:, 0], jpool.degrees,
        jcam.params(), jnp.asarray(BG), width=W, height=H,
        instance_budget=budget, alive_mask=jpool.alive, backend=backend)
    got = trenderer.render(
        tpool.params.xyz, tpool.features(), tpool.params.scaling,
        tpool.params.rotation, tpool.params.opacity[:, 0], tpool.degrees,
        tcam.params("cpu"), torch.as_tensor(BG), width=W, height=H,
        instance_budget=budget, alive_mask=tpool.alive,
        backend={"pallas": "tile", "xla": "ref"}[backend])
    assert int(got.num_rendered) == int(want.num_rendered)
    if budget < BUDGET:
        assert int(got.num_rendered) > budget  # truncation is reported
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               **TOL)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(want.final_t),
                               **TOL)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_array_equal(got.visibility.numpy(),
                                  np.asarray(want.visibility))
    np.testing.assert_array_equal(
        trenderer.mark_visible(tpool.params.xyz, tcam.params("cpu")).numpy(),
        np.asarray(jrenderer.mark_visible(jpool.params.xyz, jcam.params())))


def test_unported_options_raise(jax_prep):
    tp = tprep.PreprocessOut(*(torch.as_tensor(a) for a in jax_prep))
    tb = tbin.bin_gaussians(tp, W, H, BUDGET)
    bg = torch.as_tensor(BG)
    # want_transmittance is ported: it adds the per-primitive statistics
    # and leaves the image as it was
    plain = ttr.tile_render(tp, tb, bg, W, H)
    got = ttr.tile_render(tp, tb, bg, W, H, want_transmittance=True)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert got[2].shape == got[3].shape == (tp.means2d.shape[0],)
    assert got[3].dtype == torch.int32 and int(got[3].sum()) > 1000
    # strips are ported too (tests/test_torch_strips.py): the window of
    # every tile row is the whole frame, padded to whole tiles
    gy = -(-H // 16)
    strip = ttr.tile_render(tp, tbin.bin_gaussians(tp, W, H, BUDGET,
                                                   tile_rows=(0, gy)),
                            bg, W, H, tile_rows=(0, gy))
    assert torch.equal(strip[0][:H], plain[0])
    assert torch.equal(strip[1][:H], plain[1])
    with pytest.raises(ValueError, match="grad_reduce"):
        ttr.tile_render(tp, tb, bg, W, H, grad_reduce="bf16")
