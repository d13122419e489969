"""The training preprocess's backward: PreprocessFunction and its plain
twin, preprocess_vjp_plain (the CPU's version of csrc/preprocess_bwd.cu).

* The twin against the JAX package's preprocess VJP, at
  test_torch_grad.py's tolerances (rtol 1e-4, atol 1e-5 * max|g| per
  input: the same float32 chain rule in another summation order), on its
  scene with dead slots and rows behind the camera, degrees 0-3 mixed,
  SH blocks of 1, 4, 9 and 16 coefficients, with and without the alive
  mask and a screen offset, at scale_modifier 1 and 0.6.
* PreprocessFunction called on CPU tensors against autograd of
  preprocess_torch: the same outputs bit for bit, the gradients within
  rtol 1e-5 / atol 2e-5 * max|g| (the conic's gradient is taken at the
  saved conic, -K dK K, where autograd goes through the determinant: the
  two differ by rounding on rows near singular), the screen offset's
  gradient bit for bit the incoming means2d cotangent, None for inputs
  that need none, views as inputs; its backward takes the twin and
  records no device counter.
* Ties, each split half and half as jnp.maximum splits them: a colour
  channel exactly 0 before its clamp, a view point exactly on its clamp
  limit 1.3 tan_fov, a quaternion whose norm is exactly the 1e-12 eps.

The kernel itself runs only on a card: tests/test_torch_gpu.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grad import _cams, _vjp_inputs

from one_thread import one_intra_op_thread  # noqa: F401 (a fixture)
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_torch.ops import sh as tsh
from reduced3dgs_torch.ops import transforms as ttf
from reduced3dgs_torch.utils import profiling
from reduced3dgs_tpu.ops import preprocess as jprep

LEAVES = ("xyz", "scales", "rots", "opacity", "sh")
OUTS = ("means2d", "conic", "opacity", "color")


def _cotangents(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((n, 2), (n, 3), (n,), (n, 3))]


def _saved(args, cam, kw):
    """The Function's saved set for preprocess_torch(*args, cam, **kw)."""
    out, rgb = tprep._preprocess_torch(*args, cam, **kw)
    return out, tprep.VjpSaved(*args[:6], kw.get("alive_mask"), out.radii,
                               out.depths, rgb, out.conic)


@pytest.mark.parametrize("coeffs,alive,offset,modifier", [
    (16, True, True, 1.0), (16, False, False, 0.6), (9, True, False, 0.6),
    (4, False, True, 1.0), (1, True, False, 1.0)])
def test_plain_vjp_matches_jax(coeffs, alive, offset, modifier):
    arrs, alive_np, cot = _vjp_inputs()
    arrs = arrs[:4] + (np.ascontiguousarray(arrs[4][:, :coeffs]), arrs[5])
    n = arrs[0].shape[0]
    jc, tc = _cams()
    jcp = jc.params()
    jalive = jnp.asarray(alive_np) if alive else None
    zeros = np.zeros((n, 2), np.float32)

    def f(xyz, scales, rots, opac, feats, off):
        out = jprep.preprocess(
            xyz, scales, rots, opac, feats, jnp.asarray(arrs[5]), jcp,
            alive_mask=jalive, scale_modifier=modifier,
            screen_offset=off if offset else None)
        return out.means2d, out.conic, out.opacity, out.color

    _, pull = jax.vjp(f, *(jnp.asarray(a) for a in arrs[:5]),
                      jnp.asarray(zeros))
    want = pull(tuple(jnp.asarray(c) for c in cot))

    t = [torch.as_tensor(a) for a in arrs]
    kw = dict(alive_mask=torch.as_tensor(alive_np) if alive else None,
              scale_modifier=modifier,
              screen_offset=torch.as_tensor(zeros) if offset else None)
    out, saved = _saved(t, tc.params("cpu"), kw)
    got = tprep.preprocess_vjp_plain(saved, tc.params("cpu"), modifier,
                                     [torch.as_tensor(c) for c in cot])
    culled = out.radii == 0
    assert bool(culled[-10:].all()) and 0 < int(culled.sum()) < n
    assert set(arrs[5].tolist()) == {0, 1, 2, 3}
    for name, a, b in zip(LEAVES, want, got):
        a = np.asarray(a)
        assert np.isfinite(b.numpy()).all(), name
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max(), err_msg=name)
    # JAX's screen offset gradient is the means2d cotangent
    if offset:
        np.testing.assert_array_equal(np.asarray(want[5]), cot[0])
    # culled rows' gradients reach xyz only, through means2d
    for g in got[1:]:
        assert not g[culled].any()


def _function_case(case):
    """(leaves, rest, kw, need): preprocess's inputs for a Function case
    and the names of the leaves a gradient is asked of."""
    arrs, alive_np, _ = _vjp_inputs()
    n = arrs[0].shape[0]
    need = LEAVES + ("offset",)
    if case == "views":
        # as the trainer and the sharded step pass them: row slices of
        # wider leaves, xyz columns of a wider buffer, opacity[:, 0], the
        # features' concatenation
        big = [np.concatenate([a, a[:7]]) for a in arrs]
        xyz4 = torch.as_tensor(np.concatenate(
            [big[0], np.zeros((n + 7, 1), np.float32)], 1))
        opac2 = torch.as_tensor(big[3][:, None])
        leaves = [xyz4, torch.as_tensor(big[1]), torch.as_tensor(big[2]),
                  opac2, torch.as_tensor(big[4])]
        for t in leaves:
            t.requires_grad_(True)
        off = torch.zeros((n + 7, 2), requires_grad=True)
        feats = torch.cat([leaves[4][:, :1], leaves[4][:, 1:]], dim=1)
        own = slice(0, n)
        inputs = [xyz4[own, :3], leaves[1][own], leaves[2][own],
                  opac2[own, 0], feats[own]]
        assert not inputs[0].is_contiguous()
        kw = dict(alive_mask=torch.as_tensor(alive_np),
                  screen_offset=off[own])
        return leaves + [off], inputs, torch.as_tensor(big[5])[own], kw, \
            need
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in arrs[:5]]
    off = torch.zeros((n, 2), requires_grad=True)
    kw = dict(alive_mask=torch.as_tensor(alive_np), screen_offset=off)
    if case == "xyz_only":
        for t in leaves[1:]:
            t.requires_grad_(False)
        need = ("xyz",)
        kw.pop("screen_offset")
    elif case == "modifier":
        kw.update(scale_modifier=0.6, alive_mask=None)
    elif case == "sh_only_no_offset":
        for t in leaves[:4]:
            t.requires_grad_(False)
        need = ("sh",)
        kw.pop("screen_offset")
    wrt = [t for t in leaves if t.requires_grad] + (
        [off] if "screen_offset" in kw else [])
    return wrt, leaves, torch.as_tensor(arrs[5]), kw, need


@pytest.mark.parametrize("case", ["full", "xyz_only", "sh_only_no_offset",
                                  "modifier", "views"])
def test_function_matches_autograd(case, monkeypatch):
    """PreprocessFunction on CPU tensors against autograd through
    preprocess_torch, for the same cotangents."""
    cam = _cams()[1].params("cpu")
    twin, plain = [], tprep.preprocess_vjp_plain

    def spy(*a):
        twin.append(1)
        return plain(*a)

    monkeypatch.setattr(tprep, "preprocess_vjp_plain", spy)
    results = []
    for fn in (tprep.preprocess_torch, tprep.preprocess_function):
        wrt, inputs, degrees, kw, need = _function_case(case)
        out = fn(*inputs, degrees, cam, **kw)
        cot = [torch.as_tensor(c) for c in _cotangents(inputs[0].shape[0])]
        pairs = [(getattr(out, k), c) for k, c in zip(OUTS, cot)
                 if getattr(out, k).requires_grad]
        outs, cots = zip(*pairs)
        grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
        results.append((out, grads, cot))
    (o_ref, g_ref, cot), (o_fn, g_fn, _) = results
    assert len(twin) == 1
    for name, a, b in zip(tprep.PreprocessOut._fields, o_ref, o_fn):
        assert torch.equal(a.detach(), b), name
        assert b.requires_grad == (name in OUTS), name
    for name, a, b in zip(need, g_ref, g_fn):
        assert a is not None and b is not None, name
        if name == "offset":  # bit for bit the means2d cotangent
            n = cot[0].shape[0]
            assert torch.equal(b, a) and torch.equal(b[:n], cot[0])
            assert not b[n:].any()
            continue
        np.testing.assert_allclose(
            b.numpy(), a.numpy(), rtol=1e-5,
            atol=2e-5 * float(a.abs().max()), err_msg=name)


def test_function_passes_none_where_no_gradient_is_asked():
    """needs_input_grad: leaves that require none get None, and a backward
    whose cotangents are all absent runs no VJP."""
    arrs, alive_np, _ = _vjp_inputs()
    cam = _cams()[1].params("cpu")
    t = [torch.as_tensor(a) for a in arrs]
    t[2].requires_grad_(True)
    out = tprep.preprocess_function(*t, cam,
                                    alive_mask=torch.as_tensor(alive_np))
    (g,) = torch.autograd.grad(out.conic.sum(), [t[2]])
    assert g.shape == t[2].shape and g.abs().max() > 0
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(out.conic.sum(), [t[0]])
    profiling.reset()
    with profiling.enable():
        out = tprep.preprocess_function(*t, cam)
        out.color.sum().backward()
        snap = profiling.snapshot()
    assert "preprocess_bwd" not in snap["counters"]


def _tie_scene():
    """Three valid rows on a camera looking down +z from (0, 0, -3) with
    an identity rotation, so the view point is xyz + (0, 0, 3) exactly:
    row 0 of degree 0 whose colour is exactly 0 before the clamp, row 1
    with t / tz exactly on the clamp limit 1.3 tan_fovx, row 2 with a
    quaternion of norm exactly 1e-12; row 3 a plain row."""
    w, h = 64, 48
    fov_x = math.radians(60.0)
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * h / w)
    view = torch.eye(4)
    view[3, 2] = 3.0
    proj = torch.as_tensor(ttf.projection_matrix(0.01, 100.0, fov_x, fov_y))
    cam = tprep.CameraParams(
        view, view @ proj.T, torch.tensor([0.0, 0.0, -3.0]),
        torch.tensor(math.tan(fov_x / 2), dtype=torch.float32),
        torch.tensor(math.tan(fov_y / 2), dtype=torch.float32), w, h)
    lim = 1.3 * cam.tan_fovx
    xyz = torch.tensor([[0.1, -0.1, 0.0], [0.0, 0.05, 1.0],
                        [-0.2, 0.1, 0.5], [0.15, 0.2, -0.5]])
    xyz[1, 0] = 4.0 * lim  # tz = 4: t / tz = lim exactly
    scales = torch.log(torch.tensor([[0.3, 0.1, 0.05], [0.2, 0.4, 0.1],
                                     [0.1, 0.3, 0.2], [0.25, 0.05, 0.15]]))
    rots = torch.tensor([[1.0, 0.2, -0.1, 0.3], [0.9, -0.3, 0.2, 0.1],
                         [1e-12, 0.0, 0.0, 0.0], [0.5, 0.5, -0.5, 0.5]])
    opac = torch.tensor([0.5, 1.0, -0.3, 0.2])
    sh = 0.3 * torch.randn((4, 16, 3),
                           generator=torch.Generator().manual_seed(2))
    c0 = torch.tensor(tsh.SH_C0, dtype=torch.float32)
    sh[0, 0] = -0.5 / c0  # C0 * sh = -0.5 exactly: rgb = 0
    degrees = torch.tensor([0, 3, 2, 3], dtype=torch.int32)
    return (xyz, scales, rots, opac, sh, degrees), cam


@pytest.mark.parametrize("tie", ["colour_zero", "clamp_limit", "quat_eps"])
def test_ties_split_half_and_half(tie):
    args, cam = _tie_scene()
    out, saved = _saved(args, cam, {})
    assert bool((out.radii > 0).all())
    cot = [torch.as_tensor(c) for c in _cotangents(4, seed=9)]
    got = tprep.preprocess_vjp_plain(saved, cam, 1.0, cot)
    leaves = [a.clone().requires_grad_(True) for a in args[:5]]
    ref = tprep.preprocess_torch(*leaves, args[5], cam)
    want = torch.autograd.grad([getattr(ref, k) for k in OUTS], leaves, cot)
    for name, a, b in zip(LEAVES, want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(a.abs().max()),
                                   err_msg=name)
    if tie == "colour_zero":
        assert torch.equal(saved.rgb[0], torch.zeros(3))
        want_dc = 0.5 * torch.tensor(tsh.SH_C0, dtype=torch.float32) \
            * cot[3][0]
        assert torch.equal(got[4][0, 0], want_dc)
        assert not got[4][0, 1:].any()  # degree 0: the rest masked
    elif tie == "clamp_limit":
        t = ttf.transform_points_3x3(args[0], cam.viewmatrix)
        assert float(t[1, 0] / t[1, 2]) == float(1.3 * cam.tan_fovx)
        # the same row just inside and just outside the limit: the tie's
        # xyz gradient lies between, half-way on the clamp's term
        sides = []
        for step in (-1, 1):
            moved = [a.clone() for a in args]
            moved[0][1, 0] = torch.nextafter(
                moved[0][1, 0], torch.tensor(step * math.inf))
            o, s = _saved(moved, cam, {})
            sides.append(tprep.preprocess_vjp_plain(s, cam, 1.0, cot)[0][1])
        mid = 0.5 * (sides[0] + sides[1])
        np.testing.assert_allclose(got[0][1].numpy(), mid.numpy(),
                                   rtol=1e-3, atol=1e-3 * float(
                                       mid.abs().max()))
    else:
        n = torch.sqrt((args[2][2] * args[2][2]).sum())
        assert float(n) == float(torch.tensor(1e-12))
        assert got[2][2].abs().max() > 0
