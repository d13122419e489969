"""Camera / covariance geometry (PyTorch).

Counterpart of reduced3dgs_tpu/ops/transforms.py, with the same row-vector
convention: a homogeneous point transforms as ``p_out = p_hom @ M`` where
``M`` is the transposed world-view / full-projection matrix stored by the
Camera.  The host-side matrix constructors stay numpy, bit-identical to the
JAX package's, so both packages see the same camera matrices.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host-side (numpy) camera matrix construction
# ---------------------------------------------------------------------------

def world_to_view(R, t, translate=(0.0, 0.0, 0.0), scale=1.0):
    """World->view 4x4 (numpy); R is camera-to-world, t world-to-camera."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + np.asarray(translate)) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear, zfar, fov_x, fov_y):
    """OpenGL-style projection with z in [0,1]."""
    tan_y = math.tan(fov_y / 2)
    tan_x = math.tan(fov_x / 2)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


# ---------------------------------------------------------------------------
# Device-side (torch) transforms
# ---------------------------------------------------------------------------

def transform_points(xyz, M):
    """(P,3) @ transposed 4x4 -> homogeneous (P,4): p_hom = (p,1) @ M."""
    return xyz @ M[:3, :] + M[3, :]


def transform_points_3x3(xyz, M):
    """Affine part only: (p,1) @ M[:, :3]."""
    return xyz @ M[:3, :3] + M[3, :3]


def quat_to_rotmat(q):
    """Batched quaternion (r, x, y, z) -> (.., 3, 3) rotation matrices.
    Does NOT normalize; callers normalize."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def normalize(v, axis=-1, eps=0.0):
    # sqrt of the sum of squares, as jnp.linalg.norm computes it
    n = torch.sqrt((v * v).sum(dim=axis, keepdim=True))
    if eps:
        # torch.maximum, not clamp: at a tie it splits the gradient as
        # jnp.maximum does (torch.full: no host-to-device copy)
        n = torch.maximum(n, torch.full((), eps, dtype=n.dtype,
                                        device=n.device))
    return v / n


def build_cov3d(scales, rotations, scale_modifier=1.0):
    """Per-primitive 3D covariance R diag(s^2) R^T, packed (P, 6) as
    (xx, xy, xz, yy, yz, zz); rotations are normalized here."""
    rotations = normalize(rotations, eps=1e-12)
    R = quat_to_rotmat(rotations)  # (P,3,3)
    s = scale_modifier * scales  # (P,3)
    M = R * s[..., None, :]  # R @ diag(s): column j scaled by s_j
    m0, m1, m2 = M[:, 0, :], M[:, 1, :], M[:, 2, :]
    return torch.stack(
        [
            (m0 * m0).sum(-1), (m0 * m1).sum(-1), (m0 * m2).sum(-1),
            (m1 * m1).sum(-1), (m1 * m2).sum(-1), (m2 * m2).sum(-1),
        ],
        dim=-1,
    )


def unpack_cov3d(cov6):
    """(P,6) packed symmetric -> (P,3,3)."""
    c = cov6
    row0 = torch.stack([c[:, 0], c[:, 1], c[:, 2]], dim=-1)
    row1 = torch.stack([c[:, 1], c[:, 3], c[:, 4]], dim=-1)
    row2 = torch.stack([c[:, 2], c[:, 4], c[:, 5]], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov2d(t, focal_x, focal_y, tan_fovx, tan_fovy, cov3d6,
                  viewmatrix):
    """EWA 2D covariance (P, 3) = (cov_xx, cov_xy, cov_yy): view-space
    clamp to +-1.3 tan_fov, perspective Jacobian, +0.3 low-pass.

    Takes the view-space point ``t`` so the caller can substitute a safe
    value for culled primitives.
    """
    tz = t[:, 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    J00 = focal_x * inv_tz
    J02 = -focal_x * tx * inv_tz2
    J11 = focal_y * inv_tz
    J12 = -focal_y * ty * inv_tz2

    Wp = viewmatrix[:3, :3].T  # world->view rotation in math layout
    U0 = J00[:, None] * Wp[0][None, :] + J02[:, None] * Wp[2][None, :]
    U1 = J11[:, None] * Wp[1][None, :] + J12[:, None] * Wp[2][None, :]

    Sigma = unpack_cov3d(cov3d6)  # (P,3,3)
    S_U0 = (Sigma * U0[:, None, :]).sum(-1)  # (P,3)
    S_U1 = (Sigma * U1[:, None, :]).sum(-1)
    cov_xx = (U0 * S_U0).sum(-1) + 0.3
    cov_xy = (U0 * S_U1).sum(-1)
    cov_yy = (U1 * S_U1).sum(-1) + 0.3
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def ndc2pix(v, size):
    """NDC [-1,1] -> continuous pixel coordinate."""
    return ((v + 1.0) * size - 1.0) * 0.5
