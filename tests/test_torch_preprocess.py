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
