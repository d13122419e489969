"""Plain PyTorch reference of a `quantised_half` model's meaning: each
attribute is its codebook's float16 centre at the stored index, the
positions are float16, and the coefficients above a primitive's SH
degree are 0.  Nothing of the program is imported."""

from __future__ import annotations

import torch


def dequantise(books, ids, xyz_half, degrees):
    """Float32 leaves (xyz, features_dc (N, 1, 3), features_rest
    (N, 15, 3), scaling, rotation, opacity (N, 1)) of the quantised
    rows."""
    def look(name):
        return books[name].float()[ids[name].long()]

    rest = torch.stack([look(f"features_rest_{i}") for i in range(15)], 1)
    band = torch.arange(1, 16, device=rest.device).float().sqrt().floor()
    rest = rest * (band[None, :] <= degrees[:, None].float())[..., None]
    return dict(
        xyz=xyz_half.float(),
        features_dc=look("features_dc")[:, None, :],
        features_rest=rest,
        scaling=look("scaling"),
        rotation=torch.cat([look("rotation_re"), look("rotation_im")], 1),
        opacity=look("opacity"))
