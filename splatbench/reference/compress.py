"""Plain PyTorch reference of the compression iteration of the paper's
`full_final` schedule (Papantonakis et al., Reducing the Memory Footprint
of 3D Gaussian Splatting, PACMCGIT 2024): the redundancy metric, mercy's
`redundancy_opacity_opacity` decision and the SH-band cull's two passes.

Written for the benchmark from the published method and the reference
code's account in SURVEY.md (reduced_3dgs/: calculatePixelSize,
intersectionTest, assignFinalRedundancyValue, calculateColourVariance;
scene/gaussian_model.py: mercy_points, cull_sh_bands), in float32.  It
imports nothing of the program and takes nothing it made but the inputs
each function names: the comparisons feed it the program's state before
a step, and where a check isolates one part, the program's neighbour
lists or per-camera transmittance sums (which their own checks hold).

  * knn: exact brute force over all given points, distances
    (dx dx + dy dy) + dz dz in float32, ties to the lower row, a point
    never its own neighbour (simple-knn's distIndex2 has no tie rule);
  * the minimum projected pixel size over the cameras, a sphere of half
    the scaled pixel cube's diagonal against each neighbour's ellipsoid
    grown by that radius, in the frame of the point's own rotation (the
    reference's quirk), each point its own intersection (+1), and each
    point given the least count of the points whose list holds it;
  * mercy: the redundancy threshold mean + lambda std over the alive
    points (the unbiased std), at least mercy_minimum; among the rows
    above it, those under the median opacity of that set (the lower
    middle element); and every alive row under the 3 % opacity quantile
    (linear interpolation), capped at 0.05;
  * the cull: per camera, the mean transmittance before each blend of a
    primitive (trans_sum / max(touched, 1)) weighs the colour at each
    cumulative degree (running sum + 0.5, clamped at 0 where emitted, 0
    above the primitive's degree): transmittance-weighted distances of
    the full colour to each truncated one, and a streaming weighted mean
    and variance of the full colour (West's update), divided by the
    weight sum (NaN, read as 0, where a primitive never blended).  The
    variance pass demotes the alive rows whose mean channel std is under
    std_threshold to degree 0, their DC set to reproduce the mean colour
    and the rest zeroed; the statistics are taken again and the distance
    pass lowers, for d = 2 then 1, the alive rows whose distance to
    degree d is under cdist_threshold sqrt(3) / 255 to degree d, zeroing
    the bands above it;
  * transmittance sums: raster.py's projection and binning, composited
    here tile by tile: for each blended pair (alpha >= 1/255, T after
    the blend >= 1e-4) of an image pixel, T before it added to the
    primitive's sum and 1 to its count.

Departures from the published method: the kNN's tie rule (above); the
cull's first pass renders every camera at a budget that holds all its
instances (the reference renders whole frames too); 30 neighbours, as
published, but the pool is compacted first, so rows past the alive ones
are never neighbours (the reference's distIndex2 searches the whole
tensor of live points).
"""

from __future__ import annotations

import math

import torch

from splatbench.reference import raster

NEIGHBOURS = 30
SH_BOUNDS = (1, 4, 9, 16)  # coefficients up to degree 0..3


# ---------------------------------------------------------------------------
# the redundancy metric
# ---------------------------------------------------------------------------

def sq_dist(a, b):
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def knn(points, queries, k: int = NEIGHBOURS, rows: int = 128):
    """(Q, k) int64 rows of `points` (N, 3) nearest to each of the rows
    `queries` (Q,), ascending by (distance, row), the query itself left
    out: brute force over all N, `rows` queries at a time."""
    out = []
    ids = torch.arange(points.shape[0], device=points.device)
    for q0 in range(0, queries.numel(), rows):
        q = queries[q0:q0 + rows]
        d2 = sq_dist(points[q][:, None, :], points[None, :, :])
        d2[torch.arange(q.numel(), device=d2.device), q] = torch.inf
        # the k + 2 least by value hold every row up to the k-th where the
        # (k + 2)-th is farther; sorted by row, then stably by distance
        vals, cand = torch.topk(d2, k + 2, dim=1, largest=False)
        by_row = torch.argsort(cand, dim=1)
        vals, cand = vals.gather(1, by_row), cand.gather(1, by_row)
        by_d = torch.argsort(vals, dim=1, stable=True)
        vals, cand = vals.gather(1, by_d), cand.gather(1, by_d)
        pick = cand[:, :k].clone()
        for j in torch.nonzero(vals[:, k + 1] <= vals[:, k - 1]).flatten():
            row = d2[j]  # three or more rows tied at the k-th: all of them
            near = ids[row <= vals[j, k - 1]]
            near = near[torch.argsort(near)]
            near = near[torch.argsort(row[near], stable=True)]
            pick[j] = near[:k]
        out.append(pick)
        del d2
    return torch.cat(out) if out else ids.new_zeros((0, k))


def pixel_size(xyz, cams):
    """(N,) least world-space length over the cameras of a one-pixel step
    in NDC at each point's depth, 1e4 where no camera sees it.  cams:
    [(proj, inv_proj, width, height)] with the row-vector (4, 4)
    matrices of the published cameras."""
    one = torch.ones_like(xyz[:, :1])
    h = torch.cat([xyz, one], 1)
    best = None
    for proj, inv, w, hgt in cams:
        p = h @ proj
        ndc = p[:, :3] * (1.0 / (p[:, 3] + 1e-7))[:, None]
        seen = ((ndc[:, 0].abs() <= 1) & (ndc[:, 1].abs() <= 1)
                & (ndc[:, 2] >= 0) & (ndc[:, 2] <= 1))
        step = (2.0 / w, 0.0) if w > hgt else (0.0, 2.0 / hgt)
        z = ndc[:, 2:3]
        a = torch.cat([one * step[0], one * step[1], z, one], 1) @ inv
        b = torch.cat([one * 0.0, one * 0.0, z, one], 1) @ inv
        d = a[:, :3] / (a[:, 3:4] + 1e-7) - b[:, :3] / (b[:, 3:4] + 1e-7)
        size = torch.where(seen, torch.sqrt((d * d).sum(1)), 1e4)
        best = size if best is None else torch.minimum(best, size)
    return best


def rotation_matrices(q):
    """(N, 3, 3) from unit quaternions (r, x, y, z)."""
    r, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], 1).reshape(-1, 3, 3)


def redundancy(xyz, scales, quats, neighbours, cams, pixel_scale=1.0):
    """(N,) each point's least intersection count among the points whose
    list holds it (itself included); N = the alive points, with their
    activated scales and normalised quaternions and their (N, k)
    neighbour rows."""
    n = xyz.shape[0]
    radius = pixel_size(xyz, cams) * pixel_scale * math.sqrt(3.0) / 2.0
    rot = rotation_matrices(quats)
    diff = xyz[:, None, :] - xyz[neighbours]  # (N, k, 3)
    local = torch.einsum("nki,nij->nkj", diff, rot)
    grown = scales[neighbours] + radius[:, None, None]
    hit = ((local / grown) ** 2).sum(-1) < 1.0
    counts = hit.sum(1) + 1
    lists = torch.cat([torch.arange(n, device=xyz.device)[:, None],
                       neighbours], 1)
    member = torch.cat([torch.ones_like(hit[:, :1]), hit], 1)
    least = torch.full((n,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=xyz.device)
    least.scatter_reduce_(0, lists[member],
                          counts[:, None].expand_as(lists)[member], "amin")
    return least


def mercy(alive, red, opacity, lambda_mercy=1.0, mercy_minimum=3):
    """The alive mask after mercy_type redundancy_opacity_opacity: red
    and opacity (activated) over the whole capacity."""
    r = red[alive].double()
    thr = max(float(r.mean() + lambda_mercy * r.std()), float(mercy_minimum))
    over = alive & (red.double() > thr)
    median = torch.sort(opacity[over]).values
    cut = alive & over
    if median.numel():
        cut = cut & (opacity < median[(median.numel() - 1) // 2])
    o = torch.sort(opacity[alive]).values
    pos = 0.03 * (o.numel() - 1)
    lo = int(math.floor(pos))
    q = o[lo] + (o[min(lo + 1, o.numel() - 1)] - o[lo]) * (pos - lo)
    cut = cut | (alive & (opacity < min(float(q), 0.05)))
    return alive & ~cut


# ---------------------------------------------------------------------------
# the SH-band cull
# ---------------------------------------------------------------------------

def transmittance(p: raster.Projected, bins: raster.Bins, width: int,
                  height: int):
    """(trans_sum (N,), touched (N,), pairs) of one render: per
    primitive, over the image's pixels where it blends, the transmittance
    before the blend and the number of those pixels; pairs: the image's
    (blended pairs, stopped pixels, walked pairs) as raster.composite
    counts them."""
    n = p.xy.shape[0]
    dev = p.xy.device
    trans = torch.zeros(n, dtype=p.xy.dtype, device=dev)
    touched = torch.zeros(n, dtype=torch.int64, device=dev)
    pairs = [0, 0, 0]
    gx = -(-width // raster.TILE)
    for tiles, k in raster._chunks(bins):
        slot = torch.arange(k, device=dev)
        have = slot[None, :] < bins.count[tiles][:, None]
        idx = torch.where(have, bins.start[tiles][:, None] + slot[None, :],
                          0)
        prim = bins.prim[idx] if bins.prim.numel() else torch.zeros_like(idx)
        lin = torch.arange(raster.TILE * raster.TILE, device=dev)
        px = (tiles % gx)[:, None] * raster.TILE + lin[None, :] % raster.TILE
        py = (tiles // gx)[:, None] * raster.TILE + lin[None, :] \
            // raster.TILE
        inside = ((px < width) & (py < height))[..., None]
        dx = p.xy[prim, 0][:, None, :] - px.to(p.xy.dtype)[:, :, None]
        dy = p.xy[prim, 1][:, None, :] - py.to(p.xy.dtype)[:, :, None]
        cn = p.conic[prim]
        power = (-0.5 * (cn[..., 0][:, None, :] * dx * dx
                         + cn[..., 2][:, None, :] * dy * dy)
                 - cn[..., 1][:, None, :] * dx * dy)
        alpha = torch.clamp(p.opacity[prim][:, None, :]
                            * torch.exp(torch.clamp(power, max=0.0)),
                            max=raster.ALPHA_MAX)
        hit = have[:, None, :] & (alpha >= raster.ALPHA_MIN)
        a = torch.where(hit, alpha, 0.0)
        after = torch.cumprod(1.0 - a, dim=2)
        before = torch.cat([torch.ones_like(after[..., :1]),
                            after[..., :-1]], 2)
        blend = hit & (after >= raster.T_MIN) & inside
        ids = prim[:, None, :].expand_as(blend)[blend]
        trans.index_add_(0, ids, before[blend])
        touched.index_add_(0, ids, torch.ones_like(ids))
        stop = hit & (after < raster.T_MIN) & inside
        stopped = stop.any(2)
        walked = torch.where(stopped, stop.float().argmax(2) + 1,
                             bins.count[tiles][:, None])
        for j, c in enumerate((blend.sum(), stopped.sum(), torch.where(
                inside[..., 0], walked, 0).sum())):
            pairs[j] += int(c)
    return trans, touched, tuple(pairs)


def render_transmittance(leaves, sh, degrees, alive, cam: raster.Camera):
    """(radius, trans_sum, touched) of one camera's render of the state
    (raw leaves, (N, 16, 3) coefficients)."""
    p = raster.project(leaves["xyz"], sh, leaves["scaling"],
                       leaves["rotation"], leaves["opacity"][:, 0], degrees,
                       alive, cam)
    bins = raster.bin_tiles(p, cam.width, cam.height)
    t, c, _ = transmittance(p, bins, cam.width, cam.height)
    return p.radius, t, c


def degree_colours(sh, xyz, centre, degrees):
    """(N, 4, 3) colour at each cumulative degree seen from `centre`."""
    d = xyz - centre[None, :]
    d = d / torch.clamp(d.norm(dim=1, keepdim=True), min=1e-12)
    terms = raster.sh_basis(d)[..., None] * sh  # (N, 16, 3)
    running = terms[:, 0] + 0.5
    out = [torch.clamp(running, min=0.0)]
    for lo, hi in zip(SH_BOUNDS[:-1], SH_BOUNDS[1:]):
        running = running + terms[:, lo:hi].sum(1)
        out.append(torch.clamp(running, min=0.0))
    out = torch.stack(out, 1)
    keep = torch.arange(4, device=sh.device)[None, :] <= degrees[:, None]
    return out * keep[..., None].to(out.dtype)


def stats_start(xyz):
    """Empty statistics of the cull over the rows of `xyz`: (weight sum,
    distances, mean, variance)."""
    n = xyz.shape[0]
    return (torch.zeros(n, 1, dtype=xyz.dtype, device=xyz.device),
            *(torch.zeros(n, 3, dtype=xyz.dtype, device=xyz.device)
              for _ in range(3)))


def stats_add(acc, sh, xyz, degrees, view):
    """`acc` with one camera added: view (centre, radius, trans_sum,
    touched) of a render of the rows."""
    w_sum, dist, mean, var = acc
    centre, radius, t_sum, touched = view
    seen = (radius > 0)[:, None]
    w = (t_sum / torch.clamp(touched, min=1).to(t_sum.dtype))[:, None]
    cols = degree_colours(sh, xyz, centre, degrees)
    cols = torch.where(seen[..., None], cols, 0.0)
    full = cols[:, 3]
    d = torch.sqrt(((full[:, None, :] - cols[:, :3]) ** 2).sum(-1))
    dist = dist + w * torch.nan_to_num(d)
    new_sum = w_sum + w
    step = torch.nan_to_num(w / new_sum)
    mean_new = mean + step * (full - mean)
    var = var + w * (full - mean) * (full - mean_new)
    return new_sum, dist, mean_new, var


def stats_result(acc):
    """(distances (N, 3), variance (N, 3), mean (N, 3)): divided by the
    weight sum (NaN where a row never blended)."""
    w_sum, dist, mean, var = acc
    return dist / w_sum, var / w_sum, mean


def colour_stats(sh, xyz, degrees, views):
    """stats_result over `views` [(centre, radius, trans_sum, touched)]
    in camera order."""
    acc = stats_start(xyz)
    for view in views:
        acc = stats_add(acc, sh, xyz, degrees, view)
    return stats_result(acc)


def variance_pass(features, degrees, alive, var, mean, std_threshold):
    """(features, degrees) after the variance pass."""
    std = torch.nan_to_num(torch.sqrt(var)).mean(1)
    low = alive & (std < std_threshold)
    out = features.clone()
    out[low, 0] = (mean[low] - 0.5) / raster.SH_C0
    out[low, 1:] = 0.0
    return out, torch.where(low, 0, degrees)


def distance_pass(features, degrees, alive, dist, threshold):
    """(features, degrees) after the distance pass."""
    dist = torch.nan_to_num(dist)
    out = features.clone()
    degrees = degrees.clone()
    for d in (2, 1):
        low = alive & (dist[:, d] < threshold)
        degrees = torch.where(low, torch.clamp(degrees, max=d), degrees)
        out[low, SH_BOUNDS[d]:] = 0.0
    return out, degrees


def cull(features, degrees, alive, xyz, first_views, second_views,
         std_threshold, cdist_threshold):
    """(features, degrees) after both passes: first_views / second_views
    each [(centre, radius, trans_sum, touched)] of every camera, the
    renders of the state before each pass (its statistics are taken
    again after the variance pass)."""
    _, var, mean = colour_stats(features, xyz, degrees, first_views)
    features, degrees = variance_pass(features, degrees, alive, var, mean,
                                      std_threshold)
    dist, _, _ = colour_stats(features, xyz, degrees, second_views)
    return distance_pass(features, degrees, alive, dist,
                         cdist_threshold * math.sqrt(3.0) / 255.0)
