"""Gaussian primitive pool (PyTorch tensors on one device).

Counterpart of reduced3dgs_tpu/models/gaussians.py for the serving path: a
fixed-capacity pool with an alive mask, rows padded to a power-of-two
capacity exactly as the JAX pool is, so both packages hold the same slots.
The training-side state (densify accumulators, capacity growth) comes
with training.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from reduced3dgs_torch.device import resolve


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

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    def features(self) -> torch.Tensor:
        """(C, 16, 3) dense SH coefficients (dc ++ rest)."""
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)


def round_capacity(n: int, minimum: int = 1024) -> int:
    """Next power-of-two bucket >= n."""
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


_PARAM_SHAPES = {
    "xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
    "scaling": (3,), "rotation": (4,), "opacity": (1,),
}


def pool_from_numpy(leaves: dict, device=None) -> GaussianPool:
    """Build the pool from numpy arrays of the JAX pool's leaves
    (xyz, features_dc, features_rest, scaling, rotation, opacity,
    degrees, alive), each converted with np.asarray — so both packages
    render the same model."""
    dev = resolve(device)

    def t(name, dtype):
        return torch.as_tensor(np.ascontiguousarray(leaves[name]),
                               dtype=dtype, device=dev)

    params = GaussianParams(**{k: t(k, torch.float32)
                               for k in _PARAM_SHAPES})
    return GaussianPool(params=params, degrees=t("degrees", torch.int32),
                        alive=t("alive", torch.bool))


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
