"""Port parity of the training step's gradients: the preprocess VJP and
the tile renderer's backward (K3, K5/K6 plain versions), torch vs JAX.

JAX runs on the CPU with its Pallas kernels in interpret mode, as
tests/test_tile_render.py runs them; the port runs the plain versions of
its kernels.  Tolerances:

* preprocess VJP: rtol 1e-4, atol 1e-5 * max|g| per input (the same
  float32 chain rule in another summation order);
* K3 per instance: 1e-5 of each gradient row's max, and exactly 0 on
  every slot outside the walked tile ranges;
* segment sums: rtol 2e-5, atol 2e-4 (tests/test_tile_render.py:192);
* whole-render gradients in f32 mode: atol 2e-4 * max|g|, rtol 2e-3
  (tests/test_tile_render.py:84-87); bf16x2 mode within 2e-2 * max|g|
  (tests/test_tile_render.py:215-218) of the f32 gradients and of the JAX
  package's bf16x2 gradients (one bf16 rounding of a per-instance value
  may differ by one bf16 step between the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tile_render import BUDGET, H, W, make_scene

import chip_smoke as cs
from chip_smoke import ragged_segments

from reduced3dgs_torch import renderer as trenderer
from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.ops import binning as tbin
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_torch.ops import tile_render as ttr
from reduced3dgs_tpu import renderer as jrenderer
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.ops import binning as jbin
from reduced3dgs_tpu.ops import preprocess as jprep
from reduced3dgs_tpu.ops import tile_render as jtr

EYE = (0.3, -0.2, -3.2)
BG = np.array([0.2, 0.1, 0.4], np.float32)


def _cams():
    return (JCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H),
            TCamera.look_at(eye=EYE, target=(0, 0, 0), width=W, height=H))


def _vjp_inputs():
    """make_scene plus 20 dead slots (zero parameters, identity rotation)
    and 10 primitives behind the camera."""
    xyz, feats, scales, rots, opac, deg = (np.array(a) for a in make_scene())
    n = xyz.shape[0]
    xyz[n - 10:] = np.array([0.3, -0.2, -3.6], np.float32)  # behind the eye
    dead = slice(n - 30, n - 10)
    for a in (xyz, feats, scales, opac):
        a[dead] = 0.0
    rots[dead] = np.array([1, 0, 0, 0], np.float32)
    alive = np.ones(n, bool)
    alive[dead] = False
    rng = np.random.default_rng(5)
    cot = [rng.normal(0, 1, s).astype(np.float32)
           for s in ((n, 2), (n, 3), (n,), (n, 3))]
    return (xyz, scales, rots, opac, feats, deg), alive, cot


def test_preprocess_vjp_matches_jax():
    """dL/d(xyz, scales, rots, opacity, SH, screen_offset) for a random
    cotangent of (means2d, conic, opacity, color), dead and culled rows
    included."""
    arrs, alive, cot = _vjp_inputs()
    n = arrs[0].shape[0]
    jc, tc = _cams()
    jcp = jc.params()

    @jax.jit
    def jax_vjp(xyz, scales, rots, opac, feats, off):
        def f(*a):
            out = jprep.preprocess(*a[:5], arrs[5], jcp,
                                   alive_mask=jnp.asarray(alive),
                                   screen_offset=a[5])
            return out.means2d, out.conic, out.opacity, out.color
        outs, pull = jax.vjp(f, xyz, scales, rots, opac, feats, off)
        return outs, pull(tuple(jnp.asarray(c) for c in cot))

    off = np.zeros((n, 2), np.float32)
    (j_outs, want) = jax_vjp(*(jnp.asarray(a) for a in arrs[:5]),
                             jnp.asarray(off))
    leaves = [torch.as_tensor(a).requires_grad_(True)
              for a in (*arrs[:5], off)]
    out = tprep.preprocess(*leaves[:5], torch.as_tensor(arrs[5]),
                           tc.params("cpu"),
                           alive_mask=torch.as_tensor(alive),
                           screen_offset=leaves[5])
    t_outs = (out.means2d, out.conic, out.opacity, out.color)
    got = torch.autograd.grad(t_outs, leaves,
                              [torch.as_tensor(c) for c in cot])
    culled = np.asarray(out.radii.detach()) == 0
    assert culled[~alive].all() and culled[-10:].all()
    for a, b in zip(j_outs, t_outs):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)
    names = ["xyz", "scales", "rots", "opacity", "sh", "screen_offset"]
    for name, a, b in zip(names, want, got):
        a = np.asarray(a)
        assert np.isfinite(a).all() and np.isfinite(b.numpy()).all(), name
        np.testing.assert_allclose(
            b.numpy(), a, rtol=1e-4, atol=1e-5 * np.abs(a).max(),
            err_msg=name)
    # the culled rows' gradients reach only means2d (screen_offset)
    assert not np.asarray(got[3])[culled].any()


@pytest.fixture(scope="module")
def jax_frame():
    """JAX preprocess + binning of the shared scene (numpy leaves)."""
    xyz, feats, scales, rots, opac, deg = make_scene()
    jc, _ = _cams()
    prep = jprep.preprocess(xyz, scales, rots, opac, feats, deg,
                            jc.params())
    return jprep.PreprocessOut(*(np.asarray(a) for a in prep))


@pytest.mark.parametrize("grad_reduce", ["f32", "bf16x2"])
def test_tile_bwd_plain_matches_jax_kernel(jax_frame, grad_reduce):
    """K3's plain version against _build_bwd(interpret=True) on the same
    features, cotangent and forward output, in both table modes."""
    fast = grad_reduce == "bf16x2"
    jp = jprep.PreprocessOut(*(jnp.asarray(a) for a in jax_frame))
    jb = jbin.bin_gaussians(jp, W, H, BUDGET)
    base = jnp.zeros((1,), jnp.int32)
    grid_x, grid_y = tprep.tile_grid(W, H)
    packed, res = jtr._core_fwd(jp.means2d, jp.conic, jp.opacity, jp.color,
                                jb, base, W, H, grid_y, grad_reduce)
    feat = res[0]
    b_pad = feat.shape[1]
    g = np.random.default_rng(1).normal(
        0, 1, packed.shape).astype(np.float32)
    bwd = jtr._build_bwd(grid_x * grid_y, grid_x, W, H, b_pad,
                         -(-b_pad // jtr.K), True, fast=fast)
    limit = min(int(jb.total_padded), b_pad)
    base2 = jnp.asarray([0, limit // jtr.K], jnp.int32)
    (want,) = bwd(base2, jb.tile_ranges, feat, jnp.asarray(g), packed)
    want = np.asarray(want)

    tp = tprep.PreprocessOut(*(torch.as_tensor(a) for a in jax_frame))
    tb = tbin.bin_gaussians(tp, W, H, BUDGET)
    t_feat, _ = ttr._pack_features(tb, fast)
    np.testing.assert_array_equal(t_feat.numpy(), np.asarray(feat)[:9])
    got = ttr.tile_bwd_plain(
        t_feat, tb.tile_ranges, torch.tensor(limit, dtype=torch.int32),
        grid_x, W, H, torch.as_tensor(g), torch.as_tensor(np.asarray(packed)))
    got = got.numpy()
    assert got.shape == (9, b_pad)
    np.testing.assert_array_equal(want[9:], 0.0)
    walked = np.zeros(b_pad, bool)
    for s, e in np.asarray(jb.tile_ranges).T:
        walked[s:min(e, limit)] = True
    assert walked.sum() > 300 and (~walked).sum() > 100
    np.testing.assert_array_equal(got[:, ~walked], 0.0)
    np.testing.assert_array_equal(want[:9, ~walked], 0.0)
    for r in range(9):
        scale = np.abs(want[r]).max()
        assert scale > 0
        np.testing.assert_allclose(got[r], want[r], rtol=0,
                                   atol=1e-5 * scale, err_msg=f"row {r}")


@pytest.mark.parametrize("p", [700, 2500])
def test_segment_reduce_matches_jax(p):
    """segment_reduce_by_src (K5 / K6 plain versions) against the JAX
    package's _segment_reduce_by_src in both modes, and the f32 mode
    against a float64 segment sum."""
    fields, cols, cols_sorted = ragged_segments(p)
    jb = jbin.BinningOut(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = tbin.BinningOut(**{k: torch.as_tensor(np.asarray(v))
                            for k, v in fields.items()})
    jfn = jax.jit(jtr._segment_reduce_by_src, static_argnums=2)
    seg_bounds = fields["seg_bounds"]
    ref = np.zeros((9, p))
    for r in range(p):
        ref[:, r] = cols_sorted[:, seg_bounds[r]:seg_bounds[r + 1]].sum(
            axis=1, dtype=np.float64)
    for mode in ("f32", "bf16x2"):
        want = np.stack([np.asarray(o) for o in jfn(
            [jnp.asarray(c) for c in cols], jb, mode)])
        got = ttr.segment_reduce_by_src(torch.as_tensor(cols), tb,
                                        mode).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4,
                                   err_msg=mode)
        if mode == "f32":
            np.testing.assert_allclose(got, ref[:, fields["prim_inv"]],
                                       rtol=2e-5, atol=2e-4)


def test_packed_feature_table_roundtrip():
    """The fast (bf16x2) table mirrors test_packed_feature_table_roundtrip
    of the JAX package, with opacities >= 0.5 (the packed column's sign
    bit set): bit-identical to the JAX fast table, x/y/conic/r/g
    bitwise equal to the f32 table, opacity within its u16 half-step,
    blue within bf16 rounding."""
    p, b_pad = 64, 256
    rng = np.random.default_rng(11)
    feat = np.zeros((p, 9), np.float32)
    feat[:, 0] = rng.uniform(0, 2000, p)
    feat[:, 1] = rng.uniform(0, 1100, p)
    feat[:, 2:5] = rng.normal(0, 5, (p, 3))
    feat[:, 5] = rng.uniform(0.5, 1.0, p)
    feat[:, 6:9] = rng.uniform(0, 4, (p, 3))
    gauss = rng.integers(0, p, b_pad).astype(np.int32)
    gauss[-7:] = np.iinfo(np.int32).max
    fields = dict(gauss_aligned=gauss, tile_id=np.zeros(b_pad, np.int32),
                  tile_ranges=np.zeros((2, 1), np.int32),
                  num_rendered=np.int32(b_pad), total_padded=np.int32(b_pad),
                  seg_bounds=np.zeros(p + 1, np.int32),
                  prim_order=np.zeros(p, np.int32),
                  prim_inv=np.zeros(p, np.int32), feat_rank=feat)
    tb = tbin.BinningOut(**{k: torch.as_tensor(np.asarray(v))
                            for k, v in fields.items()})
    jb = jbin.BinningOut(**{k: jnp.asarray(v) for k, v in fields.items()})
    exact, _ = ttr._pack_features(tb, fast=False)
    packed, _ = ttr._pack_features(tb, fast=True)
    jpacked, _ = jtr._pack_features(None, None, None, None, jb, fast=True)
    e, q = exact.numpy(), packed.numpy()
    assert e.shape == q.shape == (9, b_pad)
    np.testing.assert_array_equal(q.view(np.int32),
                                  np.asarray(jpacked)[:9].view(np.int32))
    for row in (0, 1, 2, 3, 4, 6, 7):
        np.testing.assert_array_equal(q[row], e[row], err_msg=f"row {row}")
    np.testing.assert_allclose(q[5], e[5], atol=0.5 / ttr.OP_FIX + 1e-7,
                               rtol=0)
    np.testing.assert_allclose(q[8], e[8], rtol=2 ** -8, atol=0)


def _staging_ties():
    """A hand-made binning for the staging's roundings: opacities at
    exact u16 half-steps (op 65535 = q + 0.5 in f32, q even and odd),
    at 0, 1 and past the clamp, most >= 0.5 (the packed column's sign
    bit); blues at bf16 ties (low 16 bits 0x8000, even and odd), -0.0
    and 0.0; random ranks with pad slots among them."""
    rng = np.random.default_rng(5)
    ops = []
    for q in rng.integers(0, 65535, 4000):
        for d in (-1, 0, 1):
            op = np.nextafter(np.float32((q + 0.5) / 65535.0),
                              np.float32(d * 2.0), dtype=np.float32) \
                if d else np.float32((q + 0.5) / 65535.0)
            if np.float32(op) * np.float32(65535.0) == q + 0.5:
                ops.append(op)
                break
    ops = np.asarray(ops, np.float32)
    assert len(ops) > 1000
    p = ops.size + 6
    feat = rng.normal(0, 3, (p, 9)).astype(np.float32)
    feat[:ops.size, 5] = ops
    feat[ops.size:, 5] = [0.0, 1.0, 1.0 + 2 ** -10, 0.5, -0.0, 2.0]
    hi = rng.integers(0, 1 << 15, p).astype(np.uint32)
    blue = ((hi << 16) | 0x8000).view(np.float32)
    blue[::7] = -0.0
    blue[3::7] = 0.0
    feat[:, 8] = blue
    b_pad = 2 * p
    gauss = rng.integers(0, p, b_pad).astype(np.int32)
    gauss[rng.random(b_pad) < 0.1] = np.iinfo(np.int32).max
    return dict(gauss_aligned=gauss, tile_id=np.zeros(b_pad, np.int32),
                tile_ranges=np.zeros((2, 1), np.int32),
                num_rendered=np.int32(b_pad), total_padded=np.int32(b_pad),
                seg_bounds=np.zeros(p + 1, np.int32),
                prim_order=np.zeros(p, np.int32),
                prim_inv=np.zeros(p, np.int32), feat_rank=feat)


def _staging_binning(case):
    """The fields of a binning of one staging case."""
    if case == "ties":
        return _staging_ties()
    if case == "spilled":
        import test_torch_pad_spill as spill

        _, b = spill._binning(spill.make_witness())
        assert int(b.total_padded) - int(b.num_rendered) \
            > b.gauss_aligned.shape[0] - spill.BUDGET  # past the pool
    else:
        b = cs.overflow_binning(torch.device("cpu"))
    return {k: np.asarray(getattr(b, k)) for k in b._fields}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("case", ["ties", "spilled", "overflow"])
def test_walk_staging_twin_matches_jax_pack_features(case, fast):
    """WalkFeatures.table(), the plain twin of the walks' staging (each
    slot's row of feat_rank through its rank, the bf16x2 table's
    opacity and blue when quantised), bit for bit the JAX package's
    _pack_features (int32 views) on rounding ties, on the pad-spill
    witness's layout (tests/test_torch_pad_spill.py) and on a layout
    whose pads do not fit (total_padded > B_pad)."""
    fields = _staging_binning(case)
    src = ttr.WalkFeatures(torch.as_tensor(fields["feat_rank"]),
                           torch.as_tensor(fields["gauss_aligned"]), fast)
    got = src.table().numpy()
    jb = jbin.BinningOut(**{k: jnp.asarray(v) for k, v in fields.items()})
    want, b_pad = jtr._pack_features(None, None, None, None, jb, fast=fast)
    assert got.shape == (9, b_pad) and b_pad == src.b_pad
    pads = fields["gauss_aligned"] == np.iinfo(np.int32).max
    assert pads.any() and (~pads).any()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(want)[:9].view(np.int32))


def _render_grads(pkg, grad_reduce, arrs, cams):
    """Gradients of |color - 0|.mean() + 0.1 final_t.mean() w.r.t. the
    five parameter arrays, on the tile backend of either package."""
    degrees = arrs[5]
    if pkg == "jax":
        def loss(*a):
            out = jrenderer.render(
                *a, jnp.asarray(degrees), cams[0].params(), jnp.asarray(BG),
                width=W, height=H, instance_budget=BUDGET, backend="pallas",
                grad_reduce=grad_reduce)
            return jnp.abs(out.color).mean() + 0.1 * out.final_t.mean()
        g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in arrs[:5]))
        return [np.asarray(x) for x in g]
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in arrs[:5]]
    out = trenderer.render(
        *leaves, torch.as_tensor(degrees), cams[1].params("cpu"),
        torch.as_tensor(BG), width=W, height=H, instance_budget=BUDGET,
        backend="tile", grad_reduce=grad_reduce)
    loss = out.color.abs().mean() + 0.1 * out.final_t.mean()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def test_render_gradients_match_jax():
    """Whole-render gradients w.r.t. (xyz, SH, scales, rotations,
    opacity), tile backend vs the JAX package's pallas backend, with raw
    opacities up to 6 so that the 0.99 alpha clamp engages."""
    arrs = [np.array(a) for a in make_scene(seed=2)]
    arrs[4][:60] = np.random.default_rng(8).uniform(4.6, 6.0, 60)
    cams = _cams()
    # the clamp engages: sigmoid(opacity) * exp(power) >= 0.99 somewhere
    assert (1 / (1 + np.exp(-arrs[4]))).max() > 0.99
    names = ["xyz", "features", "scales", "rots", "opacity"]
    g32 = _render_grads("torch", "f32", arrs, cams)
    for name, a, b in zip(names, _render_grads("jax", "f32", arrs, cams),
                          g32):
        scale = max(np.abs(a).max(), 1e-8)
        np.testing.assert_allclose(b, a, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=f"f32 grad mismatch: {name}")
    g16 = _render_grads("torch", "bf16x2", arrs, cams)
    j16 = _render_grads("jax", "bf16x2", arrs, cams)
    for name, a, b, c in zip(names, g32, g16, j16):
        scale = np.abs(a).max()
        assert np.abs(b - a).max() < 2e-2 * scale, name
        assert np.abs(b - c).max() < 2e-2 * scale, name
