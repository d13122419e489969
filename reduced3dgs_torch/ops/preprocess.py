"""Per-Gaussian preprocessing (PyTorch): project, cull, shade.

Counterpart of reduced3dgs_tpu/ops/preprocess.py.  Vectorized over the
primitive axis; culled primitives are masked (radius 0 / 0 tiles touched)
rather than removed, so every output keeps P rows.  Differentiable in
the raw parameters (training); ties of max/min split the gradient as JAX
does (torch.maximum / torch.minimum, never torch.clamp, on the
differentiable values).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reduced3dgs_torch.ops import sh as sh_ops
from reduced3dgs_torch.ops import transforms as tf

TILE_X = 16
TILE_Y = 16


class CameraParams(NamedTuple):
    """Camera bundle: tensors on one device plus the static image size."""

    viewmatrix: torch.Tensor  # (4,4) transposed world->view
    projmatrix: torch.Tensor  # (4,4) transposed full (view @ proj)
    campos: torch.Tensor  # (3,)
    tan_fovx: torch.Tensor  # () float32
    tan_fovy: torch.Tensor  # () float32
    width: int
    height: int


class PreprocessOut(NamedTuple):
    means2d: torch.Tensor  # (P,2) pixel-space centers
    depths: torch.Tensor  # (P,) view-space z
    conic: torch.Tensor  # (P,3) inverse 2D covariance (xx, xy, yy)
    opacity: torch.Tensor  # (P,) activated opacity
    color: torch.Tensor  # (P,3) RGB from SH
    radii: torch.Tensor  # (P,) int32 pixel radius (0 = culled)
    rect_min: torch.Tensor  # (P,2) int32 tile rect (x,y) inclusive
    rect_max: torch.Tensor  # (P,2) int32 tile rect (x,y) exclusive
    tiles_touched: torch.Tensor  # (P,) int32


def tile_grid(width: int, height: int):
    return ((width + TILE_X - 1) // TILE_X, (height + TILE_Y - 1) // TILE_Y)


def _tile_index(v, grid: int):
    """float tile coordinate -> int32 clipped to [0, grid].

    Truncates toward zero like the JAX package's astype(int32) then clip.
    The float is first clamped into [-1, grid + 1], which leaves every
    clipped result unchanged but keeps the conversion in range (XLA
    saturates an out-of-range float->int conversion; a plain C cast does
    not).
    """
    v = torch.clamp(v, -1.0, grid + 1.0).to(torch.int32)
    return torch.clamp(v, 0, grid)


def get_rect(point_image, radius_x, grid_x: int, grid_y: int, radius_y=None):
    """Tile rectangle covered by a splat; per-axis extents allowed."""
    if radius_y is None:
        radius_y = radius_x
    rmin_x = _tile_index((point_image[:, 0] - radius_x) / TILE_X, grid_x)
    rmin_y = _tile_index((point_image[:, 1] - radius_y) / TILE_Y, grid_y)
    rmax_x = _tile_index(
        (point_image[:, 0] + radius_x + TILE_X - 1) / TILE_X, grid_x)
    rmax_y = _tile_index(
        (point_image[:, 1] + radius_y + TILE_Y - 1) / TILE_Y, grid_y)
    return (torch.stack([rmin_x, rmin_y], dim=-1),
            torch.stack([rmax_x, rmax_y], dim=-1))


# Binning cutoff: a pixel with alpha below the kernels' 1/255 skip adds
# nothing, so tiles entirely beyond the alpha >= 1/BIN_ALPHA_CUT level set
# are dropped from binning (300 > 255 leaves margin for rounding).
BIN_ALPHA_CUT = 300.0


def binning_extents(cov2d, opacity):
    """Per-axis pixel extents of the alpha >= 1/BIN_ALPHA_CUT level set:
    the tight, opacity-aware bounding box of the splat's ellipse."""
    r2 = torch.clamp(
        2.0 * torch.log(BIN_ALPHA_CUT * torch.clamp(opacity, min=1e-30)),
        0.0, 9.0)
    ext_x = torch.sqrt(r2 * torch.clamp(cov2d[:, 0], min=0.0))
    ext_y = torch.sqrt(r2 * torch.clamp(cov2d[:, 2], min=0.0))
    dead = opacity * BIN_ALPHA_CUT < 1.0  # alpha < 1/CUT everywhere
    return ext_x, ext_y, dead


def preprocess(
    means3d,
    scales_raw,
    rotations_raw,
    opacities_raw,
    sh,
    degrees,
    cam: CameraParams,
    *,
    alive_mask=None,
    scale_modifier=1.0,
    color_precomp=None,
    screen_offset=None,
):
    """Project + cull + shade all primitives (raw parameters in).

    degrees: (P,) int32 per-primitive SH degree; alive_mask: optional (P,)
    bool, dead pool slots are culled; color_precomp: optional (P, 3)
    colours used instead of the SH evaluation; screen_offset: optional
    zero-valued (P, 2) tensor added to the pixel centres, whose gradient
    is dL/dmean2d (the densification statistics).
    """
    grid_x, grid_y = tile_grid(cam.width, cam.height)
    focal_x = cam.width / (2.0 * cam.tan_fovx)
    focal_y = cam.height / (2.0 * cam.tan_fovy)

    # frustum cull: view z > 0.2
    p_view = tf.transform_points_3x3(means3d, cam.viewmatrix)
    depths = p_view[:, 2]
    in_front = depths > 0.2
    live = in_front if alive_mask is None else (in_front & alive_mask)

    # culled lanes get a harmless substitute point (no 0/0, 1/tz NaNs)
    # (0, 0, 1) made on the device: no host copy, so a CUDA graph can
    # capture it
    safe_pt = (torch.arange(3, device=p_view.device) == 2).to(p_view.dtype)
    t_safe = torch.where(live[:, None], p_view, safe_pt)

    # project to NDC then pixels
    p_hom = tf.transform_points(means3d, cam.projmatrix)
    p_w = 1.0 / torch.where(live, p_hom[:, 3] + 1e-7, 1.0)
    p_proj = p_hom[:, :3] * p_w[:, None]
    mean2d = torch.stack(
        [tf.ndc2pix(p_proj[:, 0], cam.width),
         tf.ndc2pix(p_proj[:, 1], cam.height)], dim=-1)
    if screen_offset is not None:
        mean2d = mean2d + screen_offset

    scales = torch.exp(scales_raw)
    cov3d = tf.build_cov3d(scales, rotations_raw, scale_modifier)
    cov2d = tf.compute_cov2d(t_safe, focal_x, focal_y, cam.tan_fovx,
                             cam.tan_fovy, cov3d, cam.viewmatrix)

    # invert to conic; det == 0 culled
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack(
        [cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv,
         cov2d[:, 0] * det_inv], dim=-1)

    # screen-space radius (3 sigma of the larger eigenvalue)
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(mid + disc, min=0.0)))
    radius_f = torch.where(live & det_ok, radius_f, 0.0)

    # reference-parity square rect: defines `radii` (visibility filter)
    ref_min, ref_max = get_rect(mean2d, radius_f, grid_x, grid_y)
    ref_tiles = ((ref_max[:, 0] - ref_min[:, 0])
                 * (ref_max[:, 1] - ref_min[:, 1]))
    valid = live & det_ok & (ref_tiles > 0)

    op_act = 1.0 / (1.0 + torch.exp(-opacities_raw))

    # tight binning rect (subset of the square rect)
    ext_x, ext_y, op_dead = binning_extents(cov2d, op_act)
    rect_min, rect_max = get_rect(
        mean2d, torch.minimum(ext_x, radius_f), grid_x, grid_y,
        radius_y=torch.minimum(ext_y, radius_f))
    tiles = torch.where(
        valid & ~op_dead,
        (rect_max[:, 0] - rect_min[:, 0]) * (rect_max[:, 1] - rect_min[:, 1]),
        0).to(torch.int32)

    if color_precomp is None:
        dirs = tf.normalize(means3d - cam.campos[None, :], eps=1e-12)
        color = sh_ops.eval_sh_color_clamped(sh, dirs, degrees)
    else:
        color = color_precomp

    opacity = torch.where(valid, op_act, 0.0)
    validf = valid.to(torch.float32)
    radii = torch.where(valid, radius_f.to(torch.int32), 0).to(torch.int32)
    return PreprocessOut(
        means2d=mean2d,
        depths=depths,
        conic=conic * validf[:, None],
        opacity=opacity,
        color=color * validf[:, None],
        radii=radii,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles,
    )
