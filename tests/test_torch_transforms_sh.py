"""Port parity: ops/transforms.py and ops/sh.py, torch vs JAX.

The same seeded numpy inputs go through the JAX function and its
counterpart in reduced3dgs_torch (on the CPU); float outputs must agree to
rtol 1e-5 (atol 1e-6 for values near zero), the host-side numpy camera
constructors bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reduced3dgs_torch.ops import sh as tsh
from reduced3dgs_torch.ops import transforms as ttf
from reduced3dgs_tpu.ops import sh as jsh
from reduced3dgs_tpu.ops import transforms as jtf

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0, n=257):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = jtf.quat_to_rotmat(
        jnp.asarray(q[:1] / np.linalg.norm(q[:1])))[0]
    view[3, :3] = rng.normal(0, 1, 3)
    t = rng.normal(0, 1, (n, 3)).astype(np.float32)
    t[:, 2] = np.abs(t[:, 2]) + 0.5
    return {
        "xyz": rng.normal(0, 1, (n, 3)).astype(np.float32),
        "M": rng.normal(0, 1, (4, 4)).astype(np.float32),
        "q": q,
        "scales": rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32),
        "dirs": dirs,
        "sh": rng.normal(0, 0.5, (n, 16, 3)).astype(np.float32),
        "degrees": rng.integers(0, 4, n).astype(np.int32),
        "view": view,
        "t": t,
        "v": rng.uniform(-1.2, 1.2, n).astype(np.float32),
        "rgb": rng.uniform(0, 1, (n, 3)).astype(np.float32),
    }


def _cov2d(mod, x, T):
    cov3d = mod.build_cov3d(T(x["scales"]), T(x["q"]), 1.3)
    tan = np.float32(math.tan(0.5))
    return mod.compute_cov2d(T(x["t"]), T(np.float32(600.0)),
                             T(np.float32(500.0)), T(tan), T(tan), cov3d,
                             T(x["view"]))


CASES = {
    "transform_points": lambda m, x, T: m.transform_points(T(x["xyz"]),
                                                           T(x["M"])),
    "transform_points_3x3": lambda m, x, T: m.transform_points_3x3(
        T(x["xyz"]), T(x["M"])),
    "quat_to_rotmat": lambda m, x, T: m.quat_to_rotmat(T(x["q"])),
    "normalize": lambda m, x, T: m.normalize(T(x["q"]), eps=1e-12),
    "build_cov3d": lambda m, x, T: m.build_cov3d(T(x["scales"]), T(x["q"]),
                                                 1.3),
    "compute_cov2d": _cov2d,
    "ndc2pix": lambda m, x, T: m.ndc2pix(T(x["v"]), 1080),
}

SH_CASES = {
    "sh_basis": lambda m, x, T: m.sh_basis(T(x["dirs"])),
    "degree_mask": lambda m, x, T: m.degree_mask(T(x["degrees"])),
    "eval_sh_color": lambda m, x, T: m.eval_sh_color(
        T(x["sh"]), T(x["dirs"]), T(x["degrees"])),
    "eval_sh_color_clamped": lambda m, x, T: m.eval_sh_color_clamped(
        T(x["sh"]), T(x["dirs"]), T(x["degrees"])),
    "rgb_to_sh": lambda m, x, T: m.rgb_to_sh(T(x["rgb"])),
}


def _compare(case, jmod, tmod, scale=None):
    x = _inputs()
    want = np.asarray(case(jmod, x, jnp.asarray))
    got = case(tmod, x, torch.as_tensor).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if scale is not None:
        s = scale(want)
        want, got = want / s, got / s
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _cov_scale(cov):
    """Per-row sqrt(|cov_xx cov_yy|): the off-diagonal cov_xy is a sum
    that can cancel far below it (measured: one of 771 entries at 1.9e-4
    relative to itself, 2.4e-6 relative to this scale), so rtol applies
    to the covariance's own scale."""
    return np.sqrt(np.abs(cov[:, :1] * cov[:, 2:]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_transforms_match_jax(name):
    _compare(CASES[name], jtf, ttf,
             _cov_scale if name == "compute_cov2d" else None)


@pytest.mark.parametrize("name", sorted(SH_CASES))
def test_sh_matches_jax(name):
    _compare(SH_CASES[name], jsh, tsh)


def test_host_camera_matrices_bit_identical():
    rng = np.random.default_rng(1)
    R = jtf.quat_to_rotmat(jnp.asarray(
        rng.normal(0, 1, (1, 4)).astype(np.float32) / 1.7))[0]
    t = rng.normal(0, 1, 3)
    np.testing.assert_array_equal(
        ttf.world_to_view(np.asarray(R), t, (0.1, 0.2, 0.3), 1.5),
        jtf.world_to_view(np.asarray(R), t, (0.1, 0.2, 0.3), 1.5))
    np.testing.assert_array_equal(ttf.projection_matrix(0.01, 100, 1.1, 0.8),
                                  jtf.projection_matrix(0.01, 100, 1.1, 0.8))
    assert ttf.fov2focal(1.1, 800) == jtf.fov2focal(1.1, 800)
    assert ttf.focal2fov(700.0, 800) == jtf.focal2fov(700.0, 800)
