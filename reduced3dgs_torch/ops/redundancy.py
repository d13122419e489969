"""Redundancy metric for "mercy" pruning (PyTorch).

Counterpart of reduced3dgs_tpu/ops/redundancy.py:

  1. the minimum projected pixel size over all cameras,
  2. sphere / ellipsoid intersection counts against the 30 nearest
     neighbours — with the reference's quirk of using the *point's own*
     rotation for the neighbour's ellipsoid,
  3. a scatter of the minimum redundancy value to every intersecting
     neighbour (``scatter_reduce_`` "amin" for the reference's atomicMin).

The neighbours come from ops/knn.py:knn_indices (brute force up to
EXACT_LIMIT rows, the certified blocked search above) on a compacted
alive-rows-first view padded with +inf "absent" rows to a power-of-two
bucket, as the JAX package searches it.
"""

from __future__ import annotations

import math

import torch

from reduced3dgs_torch.ops.knn import knn_indices
from reduced3dgs_torch.ops.transforms import quat_to_rotmat


def min_projected_pixel_size(xyz, projmatrices, inv_projmatrices, heights,
                             widths):
    """(P,) min over cameras of the world-space length of a one-pixel NDC
    offset at each point's depth; 1e4 where never inside any frustum.
    projmatrices: (N, 4, 4) transposed full projection matrices (the
    row-vector convention of Camera.full_proj_transform)."""
    xyz1 = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)  # (P,4)
    best = None
    for proj, inv_proj, h, w in zip(projmatrices, inv_projmatrices,
                                    heights.tolist(), widths.tolist()):
        p_hom = xyz1 @ proj
        p_w = 1.0 / (p_hom[:, 3] + 1e-7)
        p_proj = p_hom[:, :3] * p_w[:, None]
        inside = ((p_proj[:, 0].abs() <= 1.0) & (p_proj[:, 1].abs() <= 1.0)
                  & (p_proj[:, 2] >= 0.0) & (p_proj[:, 2] <= 1.0))
        depth = p_proj[:, 2]
        dx, dy = (2.0 / w, 0.0) if w > h else (0.0, 2.0 / h)
        one = torch.ones_like(depth)
        p_end = torch.stack([one * dx, one * dy, depth, one], dim=1)
        p_start = torch.stack([one * 0.0, one * 0.0, depth, one], dim=1)

        def unproject(p):
            o = p @ inv_proj
            return o[:, :3] / (o[:, 3:4] + 1e-7)

        d = unproject(p_end) - unproject(p_start)
        size = torch.where(inside, torch.sqrt((d * d).sum(dim=1)), 1e4)
        best = size if best is None else torch.minimum(best, size)
    return best


def sphere_ellipsoid_intersection(xyz, scales, rotations_norm, neighbours,
                                  sphere_radius):
    """(P,) int32 intersection counts and the (P, K) mask.  For point i
    and neighbour j: sphere(center_i, r_i) against the ellipsoid at
    center_j with semi-axes scales_j + r_i in the frame of R[i] (the
    point's own rotation, as the reference has it)."""
    r = quat_to_rotmat(rotations_norm)  # (P,3,3)
    diff = xyz[:, None, :] - xyz[neighbours]  # (P,K,3)
    aug = scales[neighbours] + sphere_radius[:, None, None]  # (P,K,3)
    # difference * R  (row vector x matrix == R^T difference)
    local = torch.einsum("pki,pij->pkj", diff, r)
    q = ((local / aug) ** 2).sum(-1)
    mask = q < 1.0
    return mask.sum(dim=1).to(torch.int32), mask


def allocate_min_redundancy(red_values, neighbours, mask, num_points):
    """Each point receives the least redundancy value among the points
    whose intersection list contains it (int32 max where none does)."""
    p, k = neighbours.shape
    flat_idx = torch.where(mask, neighbours, num_points).reshape(-1).long()
    flat_val = red_values[:, None].expand(p, k).reshape(-1)
    out = torch.full((num_points + 1,), torch.iinfo(red_values.dtype).max,
                     dtype=red_values.dtype, device=red_values.device)
    out.scatter_reduce_(0, flat_idx, flat_val, "amin")
    return out[:num_points]


def _redundancy_core(pts, scales, rotations_norm, absent, neighbours,
                     projmatrices, inv_projmatrices, heights, widths,
                     pixel_scale):
    p = pts.shape[0]
    # absent rows carry inf coordinates; keep the projection finite for
    # them (their outputs are masked below)
    safe = torch.where(absent[:, None], 0.0, pts)
    cube_size = min_projected_pixel_size(
        safe, projmatrices, inv_projmatrices, heights, widths)
    half_diag = cube_size * pixel_scale * math.sqrt(3.0) / 2.0
    counts, mask = sphere_ellipsoid_intersection(
        safe, scales, rotations_norm, neighbours, half_diag)
    # absent rows intersect nothing, scatter nothing and are never a
    # valid neighbour
    mask = mask & ~absent[:, None] & ~absent[neighbours]
    counts = torch.where(absent, 0, counts + 1).to(torch.int32)  # + self
    self_idx = torch.arange(p, device=pts.device)[:, None]
    neighbours = torch.cat([self_idx, neighbours], dim=1)
    mask = torch.cat([~absent[:, None], mask], dim=1)
    min_red = allocate_min_redundancy(counts, neighbours, mask, p)
    return min_red, cube_size


@torch.no_grad()
def redundancy_metric(xyz, scales, rotations_norm, alive, projmatrices,
                      inv_projmatrices, heights, widths, pixel_scale=1.0,
                      num_neighbours=30, neighbours_fn=None):
    """Returns (min_redundancy (P,) int32, cube_size (P,) f32) over the
    full capacity; dead pool slots report 0.

    neighbours_fn(points (M, 3), k) -> (M, k) indices replaces the
    search (the tests hand both packages the same neighbour lists)."""
    cap = xyz.shape[0]
    dev = xyz.device
    order = torch.sort((~alive).to(torch.int32), stable=True).indices
    n_alive = int(alive.sum())
    m = max(1 << max(n_alive - 1, 1).bit_length(), num_neighbours + 1)
    m = min(m, cap)
    sel = order[:m]
    absent = torch.arange(m, device=dev) >= n_alive
    xyz_c = torch.where(absent[:, None], torch.inf, xyz[sel])
    if neighbours_fn is None:
        neighbours = knn_indices(xyz_c, num_neighbours)
    else:
        neighbours = neighbours_fn(xyz_c, num_neighbours)
    red_c, cube_c = _redundancy_core(
        xyz_c, scales[sel], rotations_norm[sel], absent, neighbours.long(),
        projmatrices, inv_projmatrices, heights, widths, float(pixel_scale))
    red = torch.zeros(cap, dtype=torch.int32, device=dev)
    red[sel] = torch.where(absent, 0, red_c).to(torch.int32)
    cube = torch.zeros(cap, dtype=torch.float32, device=dev)
    cube[sel] = torch.where(absent, 0.0, cube_c)
    return red, cube
