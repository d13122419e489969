"""Gaussian primitive pool (PyTorch tensors on one device).

Counterpart of reduced3dgs_tpu/models/gaussians.py: a fixed-capacity pool
with an alive mask, rows padded to a power-of-two capacity exactly as the
JAX pool is, so both packages hold the same slots.  Densification writes
into free slots and pruning clears alive bits (train/densify.py); the
capacity grows on the host in power-of-two buckets (``grow``).

The parameters are plain tensors in a NamedTuple (not an nn.Module): the
training step makes fresh leaves that require grad from them, and Adam
(train/adam.py) returns new tensors, so the pool stays a value that the
densify surgery can rebuild slot for slot.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from reduced3dgs_torch.device import resolve
from reduced3dgs_torch.ops import sh as sh_ops


class GaussianParams(NamedTuple):
    """Raw / pre-activation leaves: log scales, raw quaternion,
    pre-sigmoid opacity."""

    xyz: torch.Tensor  # (C, 3)
    features_dc: torch.Tensor  # (C, 1, 3)
    features_rest: torch.Tensor  # (C, 15, 3)
    scaling: torch.Tensor  # (C, 3) log-scale
    rotation: torch.Tensor  # (C, 4) unnormalized quaternion
    opacity: torch.Tensor  # (C, 1) pre-sigmoid


@dataclass
class GaussianPool:
    params: GaussianParams
    degrees: torch.Tensor  # (C,) int32 per-primitive SH degree
    alive: torch.Tensor  # (C,) bool
    # training state; zeros when not given
    max_radii2d: torch.Tensor | None = None  # (C,) f32
    xyz_grad_accum: torch.Tensor | None = None  # (C,) f32 sum |dL/dmean2d|
    denom: torch.Tensor | None = None  # (C,) f32 visibility counts
    active_sh_degree: int = 0

    def __post_init__(self):
        for name in ("max_radii2d", "xyz_grad_accum", "denom"):
            if getattr(self, name) is None:
                setattr(self, name, torch.zeros(
                    self.capacity, dtype=torch.float32, device=self.device))

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def replace(self, **kw) -> "GaussianPool":
        return dataclasses.replace(self, **kw)

    def features(self) -> torch.Tensor:
        """(C, 16, 3) dense SH coefficients (dc ++ rest)."""
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)

    def get_scaling(self):
        return torch.exp(self.params.scaling)

    def get_rotation(self):
        q = self.params.rotation
        return q / torch.sqrt((q * q).sum(-1, keepdim=True))

    def get_opacity(self):
        return torch.sigmoid(self.params.opacity)


def round_capacity(n: int, minimum: int = 1024) -> int:
    """Next power-of-two bucket >= n."""
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


_PARAM_SHAPES = {
    "xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
    "scaling": (3,), "rotation": (4,), "opacity": (1,),
}
_STATE_LEAVES = ("max_radii2d", "xyz_grad_accum", "denom")


def empty_pool(capacity: int, device=None) -> GaussianPool:
    """All slots dead: zero parameters, identity rotations."""
    dev = resolve(device)
    params = {k: torch.zeros((capacity,) + s, dtype=torch.float32,
                             device=dev) for k, s in _PARAM_SHAPES.items()}
    params["rotation"][:, 0] = 1.0
    return GaussianPool(
        params=GaussianParams(**params),
        degrees=torch.zeros(capacity, dtype=torch.int32, device=dev),
        alive=torch.zeros(capacity, dtype=torch.bool, device=dev))


def create_from_pcd(points, colors, capacity: int | None = None,
                    device=None) -> GaussianPool:
    """Initialise from a point cloud (numpy arrays): SH-DC from RGB,
    log(sqrt(mean 3-NN dist^2)) isotropic scales, identity rotations,
    opacity 0.1."""
    from reduced3dgs_torch.ops.knn import mean_knn_dist2

    dev = resolve(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    n = pts.shape[0]
    capacity = capacity or round_capacity(int(n * 4))
    pool = empty_pool(capacity, dev)
    dist2 = torch.clamp(mean_knn_dist2(pts), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    p = pool.params
    p.xyz[:n] = pts
    p.features_dc[:n, 0] = sh_ops.rgb_to_sh(cols)
    p.scaling[:n] = scales
    p.opacity[:n] = float(np.float32(np.log(0.1 / 0.9)))
    pool.alive[:n] = True
    return pool


def grow(pool: GaussianPool, new_capacity: int) -> GaussianPool:
    """Host-side capacity growth: pad every per-primitive array with dead
    slots (identity rotations keep quaternion normalisation finite)."""
    old = pool.capacity
    if new_capacity <= old:
        return pool

    def pad(x):
        return torch.cat([x, x.new_zeros((new_capacity - old,)
                                         + x.shape[1:])])

    params = GaussianParams(*(pad(x) for x in pool.params))
    params.rotation[old:, 0] = 1.0
    return pool.replace(
        params=params, degrees=pad(pool.degrees), alive=pad(pool.alive),
        **{k: pad(getattr(pool, k)) for k in _STATE_LEAVES})


def one_up_sh_degree(pool: GaussianPool, max_sh_degree: int = 3):
    """Bump the active degree and every alive primitive's own degree."""
    if pool.active_sh_degree >= max_sh_degree:
        return pool
    return pool.replace(
        active_sh_degree=pool.active_sh_degree + 1,
        degrees=torch.where(pool.alive, pool.degrees + 1,
                            pool.degrees).to(torch.int32))


def reset_opacity(pool: GaussianPool) -> GaussianPool:
    """Clamp opacity to <= 0.01 in activation space on alive slots.  The
    caller also zeroes the opacity Adam moments."""
    op = torch.clamp(pool.get_opacity(), max=0.01)
    raw = torch.log(op / (1.0 - op))
    return pool.replace(params=pool.params._replace(
        opacity=torch.where(pool.alive[:, None], raw, pool.params.opacity)))


def pool_from_numpy(leaves: dict, device=None) -> GaussianPool:
    """Build the pool from numpy arrays of the JAX pool's leaves (xyz,
    features_dc, features_rest, scaling, rotation, opacity, degrees,
    alive, and optionally max_radii2d, xyz_grad_accum, denom,
    active_sh_degree), each converted with np.asarray — so both packages
    render and train the same model."""
    dev = resolve(device)

    def t(name, dtype):
        return torch.as_tensor(np.ascontiguousarray(leaves[name]),
                               dtype=dtype, device=dev)

    params = GaussianParams(**{k: t(k, torch.float32)
                               for k in _PARAM_SHAPES})
    state = {k: t(k, torch.float32) for k in _STATE_LEAVES if k in leaves}
    return GaussianPool(
        params=params, degrees=t("degrees", torch.int32),
        alive=t("alive", torch.bool),
        active_sh_degree=int(leaves.get("active_sh_degree", 0)), **state)


def padded_leaves(arrs: dict, capacity: int | None = None) -> dict:
    """numpy pool leaves for `arrs` (load_gaussian_ply output) padded to a
    power-of-two capacity: dead rows are zero with identity rotations."""
    n = arrs["xyz"].shape[0]
    capacity = capacity or round_capacity(n)
    leaves = {}
    for k, shape in _PARAM_SHAPES.items():
        a = np.zeros((capacity,) + shape, np.float32)
        if k == "rotation":
            a[:, 0] = 1.0
        a[:n] = arrs[k]
        leaves[k] = a
    leaves["degrees"] = np.zeros(capacity, np.int32)
    leaves["degrees"][:n] = arrs["degrees"]
    leaves["alive"] = np.arange(capacity) < n
    return leaves
