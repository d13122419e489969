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
    with pytest.raises(NotImplementedError):
        ttr.tile_render(tp, tb, bg, W, H, tile_rows=(0, 1))
    with pytest.raises(ValueError, match="grad_reduce"):
        ttr.tile_render(tp, tb, bg, W, H, grad_reduce="bf16")
