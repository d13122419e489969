"""Port parity: ops/preprocess.py, torch vs JAX, on the shared test scene.

Integer outputs (radii, tile rects, tiles touched) must match exactly;
float outputs to rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_tile_render import H, W, make_scene

from reduced3dgs_torch.cameras import Camera as TCamera
from reduced3dgs_torch.ops import preprocess as tprep
from reduced3dgs_tpu.cameras import Camera as JCamera
from reduced3dgs_tpu.ops import preprocess as jprep


def _scene():
    return [np.asarray(a) for a in make_scene()]


def _run_both(variant):
    xyz, feats, scales, rots, opac, deg = _scene()
    n = xyz.shape[0]
    kw_np = {}
    if variant == "alive_mask":
        kw_np["alive_mask"] = np.arange(n) < n // 2
    if variant == "color_precomp":
        kw_np["color_precomp"] = np.random.default_rng(2).uniform(
            0, 1, (n, 3)).astype(np.float32)
    if variant == "scale_modifier":
        kw_np["scale_modifier"] = 0.7
    eye = (0.3, -0.2, -3.2)
    jc = JCamera.look_at(eye=eye, target=(0, 0, 0), width=W, height=H)
    tc = TCamera.look_at(eye=eye, target=(0, 0, 0), width=W, height=H)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw_np.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw_np.items()}
    want = jprep.preprocess(
        *(jnp.asarray(a) for a in (xyz, scales, rots, opac, feats, deg)),
        jc.params(), **jkw)
    got = tprep.preprocess(
        *(torch.as_tensor(a) for a in (xyz, scales, rots, opac, feats, deg)),
        tc.params("cpu"), **tkw)
    return want, got


@pytest.mark.parametrize("variant", ["plain", "alive_mask", "color_precomp",
                                     "scale_modifier"])
def test_preprocess_matches_jax(variant):
    want, got = _run_both(variant)
    assert int(np.asarray(want.tiles_touched).sum()) > 100
    for name, a, b in zip(want._fields, want, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_get_rect_saturates_like_xla():
    """Out-of-range and non-finite tile coordinates clip like XLA's
    saturating float->int conversion."""
    pts = np.array([[1e12, -1e12], [np.inf, -np.inf], [np.nan, 5.0],
                    [-0.5, 30.2]], np.float32)
    rad = np.array([3.0, 1.0, 2.0, 0.0], np.float32)
    want = jprep.get_rect(jnp.asarray(pts), jnp.asarray(rad), 4, 3)
    got = tprep.get_rect(torch.as_tensor(pts), torch.as_tensor(rad), 4, 3)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _contract_inputs(variant):
    """The shared scene with rows the kernel's contract is about: the
    first 24 moved behind the camera, 24 far outside the frustum, every
    fourth row dead; for "above_degree" the coefficients above each
    row's degree replaced by other values."""
    xyz, feats, scales, rots, opac, deg = (a.copy() for a in _scene())
    eye = np.float32([0.3, -0.2, -3.2])
    xyz[:24] = eye + (eye - xyz[:24]) * 0.5  # behind the near plane
    xyz[24:48] = xyz[24:48] + np.float32([40.0, 0.0, 0.0])
    alive = np.arange(xyz.shape[0]) % 4 != 3
    if variant == "above_degree":
        band = np.floor(np.sqrt(np.arange(16))).astype(np.int32)
        above = band[None, :] > deg[:, None]
        feats = np.where(above[..., None], feats + 7.5, feats)
    kw = {"alive_mask": alive}
    if variant == "precomp":
        kw["color_precomp"] = np.random.default_rng(3).uniform(
            0.1, 1, (xyz.shape[0], 3)).astype(np.float32)
    return (xyz, scales, rots, opac, feats, deg), kw, eye


def _contract_run(variant):
    args, kw, eye = _contract_inputs(variant)
    jc = JCamera.look_at(eye=tuple(eye), target=(0, 0, 0), width=W,
                         height=H)
    tc = TCamera.look_at(eye=tuple(eye), target=(0, 0, 0), width=W,
                         height=H)
    want = jprep.preprocess(*map(jnp.asarray, args), jc.params(),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tprep.preprocess(*map(torch.as_tensor, args), tc.params("cpu"),
                           **{k: torch.as_tensor(v) for k, v in kw.items()})
    return args, kw, want, got


@pytest.mark.parametrize("variant", ["sh", "precomp"])
def test_culled_rows_give_zero_colour_conic_opacity_and_radius(variant):
    """The contract csrc/preprocess_fwd.cu relies on to read no
    coefficient of a culled row: every row that is not valid (dead,
    behind the near plane, outside the frustum) has zero colour, conic,
    opacity and radius in the torch path, as in the JAX package."""
    _, kw, want, got = _contract_run(variant)
    culled = got.radii.numpy() == 0
    alive = kw["alive_mask"]
    assert culled[:24].all() and culled[24:48].all() and culled[~alive].all()
    assert 0 < (~culled).sum() < culled.size
    for out in (got, want):
        for name in ("color", "conic", "opacity", "radii"):
            v = np.asarray(getattr(out, name))
            assert (v[culled] == 0).all(), name
    for name, a, b in zip(want._fields, want, got):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_coefficients_above_the_degree_leave_the_colour():
    """The other half of that contract: a row's colour reads only the
    (d + 1)^2 coefficients its degree keeps.  Changing every coefficient
    above each row's degree changes no output of the torch path, bit for
    bit, nor of the JAX package."""
    args, _, want, got = _contract_run("above_degree")
    _, _, base_want, base_got = _contract_run("sh")
    deg = args[5]
    assert (deg < 3).sum() > 50
    for a, b in zip(got, base_got):
        assert torch.equal(a, b)
    for a, b in zip(want, base_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               rtol=1e-5, atol=1e-6)
