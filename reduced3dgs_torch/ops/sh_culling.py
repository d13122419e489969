"""Adaptive SH-band culling (PyTorch) — colour variance / distance
statistics and the two demotion passes.

Counterpart of reduced3dgs_tpu/ops/sh_culling.py.  Per training camera:

  * render with transmittance accumulation (kernel K4 on the card) ->
    per-primitive mean blend transmittance w = sum_T / max(touched, 1)
    and presence (radii > 0),
  * per-degree colours at the camera direction (clamped at each emitted
    cumulative degree, zero above the primitive's own degree),
  * accumulate w-weighted colour distances (full vs degree-d) and a
    streaming w-weighted Welford mean / variance of the full colour.

``calculate_colours_variance`` returns (avg_distances (P, D),
weighted_variance (P,1,3), weighted_mean (P,1,3)) with the reference's
division by the weight sum: NaN where a primitive never blended, which
the culling passes turn into 0 (so such primitives are demoted).

Every render of one cull starts at one instance budget; an overflowing
render is redone up the ladder by renderer.fit (counted in budget_redos),
so its statistics are those of a whole render, where the JAX package
keeps the truncated one.  The statistics run under torch.inference_mode;
the two passes build the new pool under no_grad, so its tensors can go on
training.

Tracing (utils/profiling.py): each camera's transmittance render is the
stage cull_render (its own boundaries muted) and its statistics the stage
cull_stats, then END; the device counter sh_demoted takes the rows each
pass demotes, keyed by the pass and the degree they go to.
"""

from __future__ import annotations

import torch

from reduced3dgs_torch.models.gaussians import GaussianPool
from reduced3dgs_torch.ops import sh as sh_ops
from reduced3dgs_torch.ops import transforms as tf
from reduced3dgs_torch.ops.preprocess import CameraParams
from reduced3dgs_torch.renderer import fit, render
from reduced3dgs_torch.utils import profiling

# band of each features_rest coefficient (rest index i is coefficient i+1)
_REST_BAND = (1,) * 3 + (2,) * 5 + (3,) * 7


def render_transmittance(pool: GaussianPool, features, cam: CameraParams, *,
                         budget, backend):
    """One transmittance render of the whole pool (features: its (C, 16,
    3) coefficients): (radii, trans_sum, touched) per primitive.  Starts
    at `budget` and redoes an overflow up the ladder (renderer.fit: one
    host read of num_rendered a render)."""
    def attempt(b):
        out = render(
            pool.params.xyz, features, pool.params.scaling,
            pool.params.rotation, pool.params.opacity[:, 0], pool.degrees,
            cam, torch.zeros(3, device=features.device), width=cam.width,
            height=cam.height, instance_budget=b, alive_mask=pool.alive,
            backend=backend, want_transmittance=True)
        return out, int(out.num_rendered)

    out, _ = fit(attempt, budget)
    return out.radii, out.transmittance_sum, out.pixels_touched


def _accumulate_camera(acc, xyz, features, degrees, cam: CameraParams,
                       radii, trans_sum, touched, *, max_sh_degree):
    """One camera's statistics added to acc, row by row."""
    wsum, dist_accum, mean, var = acc
    present = radii > 0
    touched = torch.clamp(touched, min=1).to(torch.float32)
    w = (trans_sum / touched)[:, None]  # (P,1)

    dirs = tf.normalize(xyz - cam.campos[None, :], eps=1e-12)
    colours = sh_ops.eval_sh_color_per_degree(
        features, dirs, degrees, max_degree=max_sh_degree)  # (P, D+1, 3)
    colours = torch.where(present[:, None, None], colours, 0.0)
    full = colours[:, max_sh_degree, :]  # (P,3)

    # distance of the full colour to each truncated-degree colour
    d = torch.sqrt(
        ((full[:, None, :] - colours[:, :max_sh_degree, :]) ** 2).sum(-1))
    dist_accum = dist_accum + w * torch.nan_to_num(d)

    new_wsum = wsum + w
    coef = torch.nan_to_num(w / new_wsum)  # 0 where the weight sum is 0
    mean_old = mean
    mean = mean_old + coef[:, :, None] * (full[:, None, :] - mean_old)
    var = var + w[:, :, None] * (full[:, None, :] - mean_old) * (
        full[:, None, :] - mean)
    return new_wsum, dist_accum, mean, var


@torch.inference_mode()
def calculate_colours_variance(pool: GaussianPool, cameras, *,
                               budget=1 << 17, backend="tile",
                               max_sh_degree=3,
                               transmittance=render_transmittance):
    """One transmittance render per camera (Camera objects or
    CameraParams on the pool's device).  Returns (avg_distances,
    weighted_variance, weighted_mean); NaN where a primitive was never
    blended (handled by the callers).

    transmittance(pool, features, cam, budget=, backend=) -> (radii,
    trans_sum, touched) of the pool's rows: the whole render by default,
    parallel/sharded.py:ShardRows.transmittance on a row shard (the
    statistics are row by row)."""
    p, dev = pool.capacity, pool.device
    acc = (torch.zeros((p, 1), device=dev),
           torch.zeros((p, max_sh_degree), device=dev),
           torch.zeros((p, 1, 3), device=dev),
           torch.zeros((p, 1, 3), device=dev))
    feats = pool.features()
    for cam in cameras:
        cp = cam.params(dev) if hasattr(cam, "params") else cam
        with profiling.part("cull_render", dev), profiling.muted():
            seen = transmittance(pool, feats, cp, budget=budget,
                                 backend=backend)
        with profiling.part("cull_stats", dev):
            acc = _accumulate_camera(acc, pool.params.xyz, feats,
                                     pool.degrees, cp, *seen,
                                     max_sh_degree=max_sh_degree)
        profiling.stage(profiling.END, dev)
    wsum, dist_accum, mean, var = acc
    return dist_accum / wsum, var / wsum[:, :, None], mean


def _demoted(rows, pass_index: int, degree: int):
    """The device counter sh_demoted: the rows a pass (0 variance, 1
    distance) lowers to `degree`."""
    if profiling.on():
        profiling.count("sh_demoted", rows.sum().to(torch.int32),
                        aux=pass_index << 2 | degree)


@torch.no_grad()
def low_variance_colour_culling(pool: GaussianPool, std_threshold,
                                weighted_variance, weighted_mean):
    """Degree-0 demotion of colour-stable primitives: the DC term is set
    to reproduce the mean observed colour and the rest is zeroed.
    Returns (pool, number demoted)."""
    std = torch.nan_to_num(torch.sqrt(weighted_variance))  # (P,1,3)
    std = std.mean(dim=2)[:, 0]  # (P,)
    mask = pool.alive & (std < std_threshold)
    _demoted(mask & (pool.degrees > 0), 0, 0)
    m3 = mask[:, None, None]
    f_dc = torch.where(m3, (weighted_mean - 0.5) / sh_ops.SH_C0,
                       pool.params.features_dc)
    f_rest = torch.where(m3, 0.0, pool.params.features_rest)
    degrees = torch.where(mask, 0, pool.degrees).to(torch.int32)
    return pool.replace(
        params=pool.params._replace(features_dc=f_dc, features_rest=f_rest),
        degrees=degrees), mask.sum()


@torch.no_grad()
def low_distance_colour_culling(pool: GaussianPool, threshold,
                                colour_distances, active_sh_degree=3):
    """Demote the bands whose colour contribution is imperceptible."""
    dists = torch.nan_to_num(colour_distances)  # (P, D)
    degrees = pool.degrees
    f_rest = pool.params.features_rest
    band = torch.tensor(_REST_BAND, device=pool.device)
    for d in range(active_sh_degree - 1, 0, -1):
        mask = pool.alive & (dists[:, d] < threshold)
        _demoted(mask & (degrees > d), 1, d)
        degrees = torch.where(mask, torch.clamp(degrees, max=d), degrees)
        kill = mask[:, None] & (band[None, :] > d)  # bands above d
        f_rest = torch.where(kill[:, :, None], 0.0, f_rest)
    return pool.replace(params=pool.params._replace(features_rest=f_rest),
                        degrees=degrees.to(torch.int32))


def cull_sh_bands(pool: GaussianPool, cameras, threshold=0.0,
                  std_threshold=0.0, *, budget=1 << 17, backend="tile",
                  max_sh_degree=3, active_sh_degree=3,
                  transmittance=render_transmittance):
    """Variance pass, recompute, distance pass (two renders per camera;
    `transmittance` as calculate_colours_variance's)."""
    kw = dict(budget=budget, backend=backend, max_sh_degree=max_sh_degree,
              transmittance=transmittance)
    _, var, mean = calculate_colours_variance(pool, cameras, **kw)
    pool, _ = low_variance_colour_culling(pool, std_threshold, var, mean)
    dists, _, _ = calculate_colours_variance(pool, cameras, **kw)
    return low_distance_colour_culling(pool, threshold, dists,
                                       active_sh_degree)
