"""Spherical-harmonics evaluation (PyTorch).

Counterpart of reduced3dgs_tpu/ops/sh.py: real SH bands 0..3 with the 3D
Gaussian Splatting constants, all 16 coefficients evaluated densely and
masked by the per-primitive degree.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

_COEFF_BAND = (0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)


def rgb_to_sh(rgb):
    """RGB in [0,1] -> DC SH coefficient."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    return sh * SH_C0 + 0.5


def sh_basis(dirs):
    """(..., 3) unit directions -> (..., 16) basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            SH_C0 * one,
            -SH_C1 * y,
            SH_C1 * z,
            -SH_C1 * x,
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ],
        dim=-1,
    )


def degree_mask(degrees, num_coeffs=16):
    """(P,) int degrees -> (P, num_coeffs) float mask of the coefficients
    whose band <= degree."""
    # band of coefficient i is floor(sqrt(i)) (_COEFF_BAND), computed on
    # the device: a host tensor here would cost a copy per render
    band = torch.arange(num_coeffs, dtype=torch.float32,
                        device=degrees.device).sqrt().floor().to(
        degrees.dtype)
    return (band[None, :] <= degrees[:, None]).to(torch.float32)


def eval_sh_color(sh, dirs, degrees):
    """(P, C, 3) SH, (P, 3) unit view dirs, (P,) degrees -> (P, 3) colour
    before the 0.5 shift."""
    c = sh.shape[-2]
    basis = sh_basis(dirs)[..., :c]  # (P, C)
    masked = basis * degree_mask(degrees, c)  # (P, C)
    return (masked[..., None] * sh).sum(dim=-2)


def eval_sh_color_clamped(sh, dirs, degrees):
    """Full forward colour: + 0.5 shift, clamped to >= 0."""
    rgb = eval_sh_color(sh, dirs, degrees) + 0.5
    return torch.maximum(rgb, torch.zeros((), dtype=rgb.dtype,
                                          device=rgb.device))


def eval_sh_color_per_degree(sh, dirs, degrees, max_degree=3):
    """Colours at each cumulative degree 0..max_degree, (P, max_degree+1,
    3), for adaptive SH-band culling.  The running sum is not clamped
    between stages, only each emitted colour is; entries above a
    primitive's own degree are 0."""
    terms = sh_basis(dirs)[..., None] * sh  # (P, 16, 3)
    running = terms[:, 0, :] + 0.5
    outs = [torch.clamp(running, min=0.0)]
    bounds = (1, 4, 9, 16)
    for d in range(1, max_degree + 1):
        running = running + terms[:, bounds[d - 1]:bounds[d], :].sum(dim=1)
        outs.append(torch.clamp(running, min=0.0))
    stacked = torch.stack(outs, dim=1)
    deg_ok = (torch.arange(max_degree + 1, device=degrees.device)[None, :]
              <= degrees[:, None])
    return stacked * deg_ok[..., None].to(stacked.dtype)
