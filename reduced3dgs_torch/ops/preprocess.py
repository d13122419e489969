"""Per-Gaussian preprocessing (PyTorch): project, cull, shade.

Counterpart of reduced3dgs_tpu/ops/preprocess.py.  Vectorized over the
primitive axis; culled primitives are masked (radius 0 / 0 tiles touched)
rather than removed, so every output keeps P rows.  Differentiable in
the raw parameters (training); ties of max/min split the gradient as JAX
does (torch.maximum / torch.minimum, never torch.clamp, on the
differentiable values).

On a card two hand-written CUDA kernels take over (`route` decides): a
render that asks for no gradient and has no screen offset runs one
forward kernel (csrc/preprocess_fwd.cu, the same outputs in one pass); a
training render (a gradient asked of the raw parameters, the screen
offset of the densification statistics beside them) runs the torch ops
below without a graph, inside PreprocessFunction, whose backward is one
kernel (csrc/preprocess_bwd.cu).  Every other call, and every call on
the CPU, runs the torch ops below under autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reduced3dgs_torch.ops import _cuda
from reduced3dgs_torch.ops import sh as sh_ops
from reduced3dgs_torch.ops import transforms as tf
from reduced3dgs_torch.utils import profiling

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
    args = (means3d, scales_raw, rotations_raw, opacities_raw, sh, degrees)
    kw = dict(alive_mask=alive_mask, scale_modifier=scale_modifier)
    rest = [t for t in (degrees, *cam[:5], alive_mask, color_precomp)
            if t is not None]
    path = route(args[:5], rest, screen_offset, color_precomp is None)
    if path == "fused":
        return preprocess_fused(*args, cam, color_precomp=color_precomp, **kw)
    if path == "function":
        return preprocess_function(*args, cam, screen_offset=screen_offset,
                                   **kw)
    return preprocess_torch(*args, cam, screen_offset=screen_offset,
                            color_precomp=color_precomp, **kw)


def preprocess_torch(
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
    """`preprocess` through the torch ops, whatever the device and the
    grad mode: the differentiable path and the CPU's."""
    return _preprocess_torch(
        means3d, scales_raw, rotations_raw, opacities_raw, sh, degrees, cam,
        alive_mask=alive_mask, scale_modifier=scale_modifier,
        color_precomp=color_precomp, screen_offset=screen_offset)[0]


def _preprocess_torch(means3d, scales_raw, rotations_raw, opacities_raw, sh,
                      degrees, cam: CameraParams, *, alive_mask=None,
                      scale_modifier=1.0, color_precomp=None,
                      screen_offset=None):
    """preprocess_torch's outputs and the SH colour before its clamp at 0
    (None with color_precomp), from which the backward reads the clamp's
    branch."""
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

    rgb = None
    if color_precomp is None:
        dirs = tf.normalize(means3d - cam.campos[None, :], eps=1e-12)
        # sh_ops.eval_sh_color_clamped, its unclamped colour kept
        rgb = sh_ops.eval_sh_color(sh, dirs, degrees) + 0.5
        color = torch.maximum(rgb, torch.zeros((), dtype=rgb.dtype,
                                               device=rgb.device))
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
    ), rgb


# ---------------------------------------------------------------------------
# The forward-only kernel (csrc/preprocess_fwd.cu)
# ---------------------------------------------------------------------------

_ARGS = ([_cuda.ctypes.c_void_p] * 5 + [_cuda.ctypes.c_int]
         + [_cuda.ctypes.c_void_p] * 8 + [_cuda.ctypes.c_int] * 3
         + [_cuda.ctypes.c_float] + [_cuda.ctypes.c_void_p] * 11)
PREPROCESS_FWD = _cuda.Kernel("preprocess_fwd", "preprocess_fwd_launch",
                              _ARGS)


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


def route(params, rest, screen_offset=None, sh_colours=True) -> str:
    """The dispatch rule of `preprocess`: which path takes a call whose
    raw parameters are `params` (means3d, scales, rotations, opacities,
    sh), whose other tensors are `rest` (degrees, the camera's, the alive
    mask, color_precomp) and whose colours come from `sh` (`sh_colours`).
    A gradient is asked for where grad mode is on and an input requires
    one.

    * "fused": every input on a card, no screen offset and no gradient
      asked -- csrc/preprocess_fwd.cu (preprocess_fused);
    * "function": every input on a card, colours from SH and a gradient
      asked of the raw parameters or the screen offset alone --
      PreprocessFunction, whose backward is csrc/preprocess_bwd.cu;
    * "torch": everything else, and the CPU always -- autograd through
      preprocess_torch."""
    offset = () if screen_offset is None else (screen_offset,)
    tensors = (*params, *rest, *offset)
    if not all(map(_on_card, tensors)):
        return "torch"
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return "torch" if offset else "fused"
    if sh_colours and not any(t.requires_grad for t in rest):
        return "function"
    return "torch"


def _require(want, dev, what):
    """Raise unless each (tensor, shape, dtype) of `want` is on the card
    `dev` with that shape and dtype."""
    for t, shape, dtype in want:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: every input on one card")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{what}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _dense(t):
    return None if t is None else t.contiguous()


def _dense_camera(cam: CameraParams) -> CameraParams:
    """The camera with its tensors contiguous (Camera.params' matrices are
    transposed views): the kernels read them through their pointers."""
    return cam._replace(**{k: _dense(getattr(cam, k))
                           for k in cam._fields[:5]})


def preprocess_fused(means3d, scales_raw, rotations_raw, opacities_raw, sh,
                     degrees, cam: CameraParams, *, alive_mask=None,
                     scale_modifier=1.0,
                     color_precomp=None) -> PreprocessOut:
    """`preprocess`'s outputs from csrc/preprocess_fwd.cu in one launch on
    the current stream (capturable: no host read, outputs from
    torch.empty).  Inputs float32 on one card (degrees int32,
    alive_mask bool, sh (P, C, 3) with C <= 16), made contiguous where
    they are views that are not (Camera.params' matrices are transposed
    views); the camera's tensors are read through their device pointers.
    Records the count of visible rows under the device counter
    "preprocess_fused"."""
    means3d, scales_raw, rotations_raw, opacities_raw, sh, degrees, \
        alive_mask, color_precomp = map(_dense, (
            means3d, scales_raw, rotations_raw, opacities_raw, sh, degrees,
            alive_mask, color_precomp))
    cam = _dense_camera(cam)
    p = means3d.shape[0]
    f32 = torch.float32
    want = [(means3d, (p, 3), f32), (scales_raw, (p, 3), f32),
            (rotations_raw, (p, 4), f32), (opacities_raw, (p,), f32),
            (degrees, (p,), torch.int32),
            (cam.viewmatrix, (4, 4), f32), (cam.projmatrix, (4, 4), f32),
            (cam.campos, (3,), f32), (cam.tan_fovx, (), f32),
            (cam.tan_fovy, (), f32)]
    if alive_mask is not None:
        want.append((alive_mask, (p,), torch.bool))
    if color_precomp is None:
        c = sh.shape[1] if sh.ndim == 3 else 0
        if not 1 <= c <= 16:
            raise ValueError("preprocess_fused: sh must be (P, C, 3), "
                             "1 <= C <= 16")
        want.append((sh, (p, c, 3), f32))
    else:
        want.append((color_precomp, (p, 3), f32))
    dev = means3d.device
    _require(want, dev, "preprocess_fused")

    def out(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    res = PreprocessOut(
        means2d=out(p, 2), depths=out(p), conic=out(p, 3), opacity=out(p),
        color=out(p, 3), radii=out(p, dtype=i32),
        rect_min=out(p, 2, dtype=i32), rect_max=out(p, 2, dtype=i32),
        tiles_touched=out(p, dtype=i32))
    visible = torch.zeros((), dtype=i32, device=dev)

    def ptr(t):
        return None if t is None else _cuda.ptr(t)

    with torch.cuda.device(dev):
        PREPROCESS_FWD(
            ptr(means3d), ptr(scales_raw), ptr(rotations_raw),
            ptr(opacities_raw), ptr(sh),
            0 if color_precomp is not None else sh.shape[1],
            ptr(degrees), ptr(alive_mask), ptr(color_precomp),
            ptr(cam.viewmatrix), ptr(cam.projmatrix), ptr(cam.campos),
            ptr(cam.tan_fovx), ptr(cam.tan_fovy), p, cam.width,
            cam.height, float(scale_modifier), *map(ptr, res),
            ptr(visible), _cuda.stream_of(means3d))
    profiling.count("preprocess_fused", visible)
    return res


# ---------------------------------------------------------------------------
# The training preprocess: an autograd Function whose backward is one
# kernel (csrc/preprocess_bwd.cu) on a card, its plain twin on the CPU
# ---------------------------------------------------------------------------

class VjpSaved(NamedTuple):
    """What the backward reads besides the camera: the raw inputs, the
    forward's decisions it does not recompute -- validity (radii > 0), the
    near-plane cull (depths > 0.2, with the alive mask) and the branch of
    the colour's clamp at 0 (the sign of rgb, the SH colour + 0.5 before
    the clamp) -- and the conic, the inverse 2D covariance, whose
    gradient is taken at the forward's own values: a determinant formed
    again within rounding of 0 could round to 0."""

    means3d: torch.Tensor  # (P, 3)
    scales_raw: torch.Tensor  # (P, 3)
    rotations_raw: torch.Tensor  # (P, 4)
    opacities_raw: torch.Tensor  # (P,)
    sh: torch.Tensor  # (P, C, 3)
    degrees: torch.Tensor  # (P,) int32
    alive_mask: torch.Tensor | None  # (P,) bool
    radii: torch.Tensor  # (P,) int32
    depths: torch.Tensor  # (P,)
    rgb: torch.Tensor  # (P, 3)
    conic: torch.Tensor  # (P, 3)


def _tie(a, b):
    """The share of d max(a, b) that goes to a: 1 where a > b, 1/2 at a
    tie (jnp.maximum's rule, which torch.maximum follows), else 0."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _normalize_vjp(v, g, eps):
    """The cotangent of v for tf.normalize(v, eps=eps) given the
    cotangent g of its result: g / m less v (g . v) / (m^2 n), m = max(n,
    eps), n = |v|, the second term weighted by _tie(n, eps) (none where
    n < eps, so no 0 / 0 at v = 0)."""
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    m = torch.maximum(n, torch.full((), eps, dtype=n.dtype, device=n.device))
    w = _tie(n, torch.full_like(n, eps))
    dn = -(g * v).sum(-1, keepdim=True) / (m * m) * w
    return g / m + v * torch.where(w > 0, dn / n, 0.0)


def preprocess_vjp_plain(saved: VjpSaved, cam: CameraParams,
                         scale_modifier, grads):
    """The VJP of preprocess_torch (color_precomp None) in torch ops: the
    plain twin of csrc/preprocess_bwd.cu, the same chain rule row by row.
    grads: the cotangents of means2d (P, 2), conic (P, 3), opacity (P,)
    and colour (P, 3), each None for zero.  Returns the cotangents of
    means3d, scales_raw, rotations_raw, opacities_raw and sh; that of a
    screen offset is the means2d cotangent itself.  Ties of max / min
    split as jnp's do; culled rows' gradients reach means3d through
    means2d only."""
    xyz, scales_raw, rots, op_raw, sh, degrees = saved[:6]
    radii, depths, rgb = saved.radii, saved.depths, saved.rgb
    p, c = xyz.shape[0], sh.shape[1]
    dev, f32 = xyz.device, torch.float32

    def grad(g, *shape):
        return torch.zeros((p, *shape), dtype=f32, device=dev) \
            if g is None else g.to(f32)

    g_m, g_conic, g_op, g_col = (grad(g, *s) for g, s in zip(
        grads, ((2,), (3,), (), (3,))))
    valid = radii > 0
    live = depths > 0.2
    if saved.alive_mask is not None:
        live = live & saved.alive_mask
    vf = valid.to(f32)[:, None]

    # means2d = ndc2pix(p_hom[:, :2] * p_w), p_w = 1 / (h3 + 1e-7) if live
    p_hom = tf.transform_points(xyz, cam.projmatrix)
    p_w = 1.0 / torch.where(live, p_hom[:, 3] + 1e-7, 1.0)
    dproj = torch.stack([g_m[:, 0] * (0.5 * cam.width),
                         g_m[:, 1] * (0.5 * cam.height)], -1)
    dp_w = (dproj * p_hom[:, :2]).sum(-1)
    dh3 = torch.where(live, -dp_w * p_w * p_w, 0.0)
    dh = torch.cat([dproj * p_w[:, None], torch.zeros_like(dh3[:, None]),
                    dh3[:, None]], -1)
    d_xyz = dh @ cam.projmatrix[:3, :].T

    # the conic of the EWA 2D covariance, on the valid rows
    safe_pt = (torch.arange(3, device=dev) == 2).to(f32)
    t = torch.where(live[:, None],
                    tf.transform_points_3x3(xyz, cam.viewmatrix), safe_pt)
    tz = t[:, 2]
    focal = (cam.width / (2.0 * cam.tan_fovx),
             cam.height / (2.0 * cam.tan_fovy))
    lims = (1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy)
    u = t[:, :2] / tz[:, None]
    lo = torch.stack([-lims[0], -lims[1]])
    hi = torch.stack([lims[0], lims[1]])
    m = torch.maximum(u, lo)
    cu = torch.minimum(m, hi)
    w_clamp = _tie(u, lo.expand_as(u)) * _tie(hi.expand_as(m), m)
    txy = cu * tz[:, None]
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    Wp = cam.viewmatrix[:3, :3].T
    J = [focal[0] * inv_tz, -focal[0] * txy[:, 0] * inv_tz2,
         focal[1] * inv_tz, -focal[1] * txy[:, 1] * inv_tz2]
    U0 = J[0][:, None] * Wp[0] + J[1][:, None] * Wp[2]
    U1 = J[2][:, None] * Wp[1] + J[3][:, None] * Wp[2]

    # the forward's own ops (tf.build_cov3d, tf.compute_cov2d): its bits;
    # the covariance C = (c0, c1, c2) = (U0 . SU0 + 0.3, U0 . SU1, U1 . SU1
    # + 0.3)
    scales = torch.exp(scales_raw)
    s = scale_modifier * scales
    qn = tf.normalize(rots, eps=1e-12)
    R = tf.quat_to_rotmat(qn)
    M = R * s[:, None, :]
    Sigma = tf.unpack_cov3d(tf.build_cov3d(scales, rots, scale_modifier))
    SU0 = (Sigma * U0[:, None, :]).sum(-1)
    SU1 = (Sigma * U1[:, None, :]).sum(-1)
    # the conic K = C^-1 of C = [[c0, c1], [c1, c2]]: dC = -K dK K, with
    # K the forward's own conic (no determinant formed again)
    g0, g1, g2 = (g_conic * vf).unbind(-1)
    k0, k1, k2 = saved.conic.unbind(-1)
    dc0 = -(g0 * k0 * k0 + g1 * k0 * k1 + g2 * k1 * k1)
    dc1 = -(2.0 * g0 * k0 * k1 + g1 * (k0 * k2 + k1 * k1)
            + 2.0 * g2 * k1 * k2)
    dc2 = -(g0 * k1 * k1 + g1 * k1 * k2 + g2 * k2 * k2)
    dSU0 = dc0[:, None] * U0
    dSU1 = dc1[:, None] * U0 + dc2[:, None] * U1
    dU0 = (dc0[:, None] * SU0 + dc1[:, None] * SU1
           + (Sigma @ dSU0[..., None])[..., 0])
    dU1 = dc2[:, None] * SU1 + (Sigma @ dSU1[..., None])[..., 0]
    dSigma = dSU0[:, :, None] * U0[:, None, :] + dSU1[:, :, None] * U1[:, None, :]
    dM = (dSigma + dSigma.transpose(1, 2)) @ M
    dR = dM * s[:, None, :]
    d_scales = (dM * R).sum(1) * scale_modifier * scales
    d_rot = _normalize_vjp(rots, _rotmat_vjp(qn, dR), 1e-12)

    # the Jacobian, the clamp of t / tz, the view point
    dJ = [(dU0 * Wp[0]).sum(-1), (dU0 * Wp[2]).sum(-1),
          (dU1 * Wp[1]).sum(-1), (dU1 * Wp[2]).sum(-1)]
    dinv_tz = dJ[0] * focal[0] + dJ[2] * focal[1]
    dinv_tz2 = -(dJ[1] * focal[0] * txy[:, 0] + dJ[3] * focal[1] * txy[:, 1])
    dtxy = -torch.stack([dJ[1] * focal[0], dJ[3] * focal[1]], -1) \
        * inv_tz2[:, None]
    dinv_tz = dinv_tz + 2.0 * inv_tz * dinv_tz2
    du = dtxy * tz[:, None] * w_clamp
    dtz = (-dinv_tz * inv_tz * inv_tz + (dtxy * cu).sum(-1)
           - (du * t[:, :2]).sum(-1) / (tz * tz))
    dt = torch.cat([du / tz[:, None], dtz[:, None]], -1) * vf
    d_xyz = d_xyz + dt @ cam.viewmatrix[:3, :3].T

    # sigmoid opacity
    e = torch.exp(-op_raw)
    r = 1.0 / (1.0 + e)
    d_op = g_op * valid.to(f32) * r * r * e

    # the degree-masked SH colour, clamped at 0
    d = xyz - cam.campos[None, :]
    dirs = tf.normalize(d, eps=1e-12)
    keep = sh_ops.degree_mask(degrees, c)
    basis = sh_ops.sh_basis(dirs)[:, :c] * keep
    g_rgb = g_col * vf * _tie(rgb, torch.zeros_like(rgb))
    d_sh = basis[..., None] * g_rgb[:, None, :]
    dbasis = torch.zeros((p, 16), dtype=f32, device=dev)
    dbasis[:, :c] = (sh * g_rgb[:, None, :]).sum(-1) * keep
    d_xyz = d_xyz + _normalize_vjp(
        d, sh_ops.sh_basis_vjp(dirs, dbasis), 1e-12)
    return d_xyz, d_scales, d_rot, d_op, d_sh


def _rotmat_vjp(q, dR):
    """The cotangent of the quaternion (r, x, y, z) of
    tf.quat_to_rotmat given that of its (P, 3, 3) result."""
    r, x, y, z = q.unbind(-1)
    d = dR.reshape(-1, 9).unbind(-1)
    dr = 2.0 * (-z * d[1] + y * d[2] + z * d[3] - x * d[5] - y * d[6]
                + x * d[7])
    dx = 2.0 * (y * d[1] + z * d[2] + y * d[3] - 2.0 * x * d[4] - r * d[5]
                + z * d[6] + r * d[7] - 2.0 * x * d[8])
    dy = 2.0 * (-2.0 * y * d[0] + x * d[1] + r * d[2] + x * d[3] + z * d[5]
                - r * d[6] + z * d[7] - 2.0 * y * d[8])
    dz = 2.0 * (-2.0 * z * d[0] - r * d[1] + x * d[2] + r * d[3]
                - 2.0 * z * d[4] + y * d[5] + x * d[6] + y * d[7])
    return torch.stack([dr, dx, dy, dz], -1)


class PreprocessFunction(torch.autograd.Function):
    """preprocess_torch (color_precomp None) with a backward of one pass
    over the rows: csrc/preprocess_bwd.cu on a card.  `preprocess` never
    sends CPU tensors here (route: autograd on the CPU); the backward's
    branch to preprocess_vjp_plain for them exists only for the CPU tests,
    which call preprocess_function directly.  The forward runs preprocess_torch's ops without a graph
    (its outputs are the same bits) and saves the raw inputs, the camera
    and VjpSaved's decisions; depths, radii, the rects and tiles_touched
    carry no gradient.  A screen offset's gradient is the incoming means2d
    gradient itself, as autograd of the sum gives it."""

    @staticmethod
    def forward(ctx, means3d, scales_raw, rotations_raw, opacities_raw, sh,
                degrees, viewmatrix, projmatrix, campos, tan_fovx, tan_fovy,
                alive_mask, screen_offset, width, height, scale_modifier):
        cam = CameraParams(viewmatrix, projmatrix, campos, tan_fovx,
                           tan_fovy, width, height)
        out, rgb = _preprocess_torch(
            means3d, scales_raw, rotations_raw, opacities_raw, sh, degrees,
            cam, alive_mask=alive_mask, scale_modifier=scale_modifier,
            screen_offset=screen_offset)
        ctx.save_for_backward(means3d, scales_raw, rotations_raw,
                              opacities_raw, sh, degrees, alive_mask,
                              out.radii, out.depths, rgb, out.conic,
                              *cam[:5])
        ctx.meta = (width, height, scale_modifier)
        ctx.mark_non_differentiable(out.depths, out.radii, out.rect_min,
                                    out.rect_max, out.tiles_touched)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_means2d, _, g_conic, g_opacity, g_color, *__):
        *saved, view, proj, campos, tan_x, tan_y = ctx.saved_tensors
        width, height, scale_modifier = ctx.meta
        need = ctx.needs_input_grad
        grads = (g_means2d, g_conic, g_opacity, g_color)
        d = (None,) * 5
        if any(need[:5]) and any(g is not None for g in grads):
            saved = VjpSaved(*saved)
            cam = CameraParams(view, proj, campos, tan_x, tan_y, width,
                               height)
            vjp = (preprocess_vjp_fused if _on_card(saved.means3d)
                   else preprocess_vjp_plain)
            d = vjp(saved, cam, scale_modifier, grads)
        return (*(g if n else None for g, n in zip(d, need)),
                *(None,) * 7, g_means2d if need[12] else None,
                None, None, None)


def preprocess_function(means3d, scales_raw, rotations_raw, opacities_raw,
                        sh, degrees, cam: CameraParams, *, alive_mask=None,
                        scale_modifier=1.0,
                        screen_offset=None) -> PreprocessOut:
    """`preprocess` through PreprocessFunction (colours from SH)."""
    return PreprocessOut(*PreprocessFunction.apply(
        means3d, scales_raw, rotations_raw, opacities_raw, sh, degrees,
        *cam[:5], alive_mask, screen_offset, cam.width, cam.height,
        float(scale_modifier)))


_BWD_ARGS = ([_cuda.ctypes.c_void_p] * 5 + [_cuda.ctypes.c_int]
             + [_cuda.ctypes.c_void_p] * 11 + [_cuda.ctypes.c_int] * 3
             + [_cuda.ctypes.c_float]
             + [_cuda.ctypes.c_void_p] + [_cuda.ctypes.c_longlong] * 2
             + [_cuda.ctypes.c_void_p] + [_cuda.ctypes.c_longlong] * 2
             + [_cuda.ctypes.c_void_p] + [_cuda.ctypes.c_longlong]
             + [_cuda.ctypes.c_void_p] + [_cuda.ctypes.c_longlong] * 2
             + [_cuda.ctypes.c_void_p] * 7)
PREPROCESS_BWD = _cuda.Kernel("preprocess_bwd", "preprocess_bwd_launch",
                              _BWD_ARGS)


def preprocess_vjp_fused(saved: VjpSaved, cam: CameraParams, scale_modifier,
                         grads):
    """preprocess_vjp_plain's gradients from csrc/preprocess_bwd.cu in one
    launch on the current stream (capturable: no host read, outputs from
    torch.empty).  Saved inputs float32 on one card (degrees and radii
    int32, the alive mask bool, sh (P, C, 3) with 1 <= C <= 16), made
    contiguous where they are views that are not; each incoming gradient
    None (zero) or float32 of its output's shape, read through its
    strides.  Records the count of valid rows under the device counter
    "preprocess_bwd"."""
    saved = VjpSaved(*map(_dense, saved))
    cam = _dense_camera(cam)
    xyz, sh = saved.means3d, saved.sh
    p = xyz.shape[0]
    c = sh.shape[1] if sh.ndim == 3 else 0
    if not 1 <= c <= 16:
        raise ValueError("preprocess_vjp_fused: sh must be (P, C, 3), "
                         "1 <= C <= 16")
    f32, i32 = torch.float32, torch.int32
    want = [(xyz, (p, 3), f32), (saved.scales_raw, (p, 3), f32),
            (saved.rotations_raw, (p, 4), f32),
            (saved.opacities_raw, (p,), f32), (sh, (p, c, 3), f32),
            (saved.degrees, (p,), i32), (saved.radii, (p,), i32),
            (saved.depths, (p,), f32), (saved.rgb, (p, 3), f32),
            (saved.conic, (p, 3), f32),
            (cam.viewmatrix, (4, 4), f32), (cam.projmatrix, (4, 4), f32),
            (cam.campos, (3,), f32), (cam.tan_fovx, (), f32),
            (cam.tan_fovy, (), f32)]
    if saved.alive_mask is not None:
        want.append((saved.alive_mask, (p,), torch.bool))
    want += [(g, (p, *s), f32) for g, s in zip(
        grads, ((2,), (3,), (), (3,))) if g is not None]
    dev = xyz.device
    _require(want, dev, "preprocess_vjp_fused")

    def ptr(t):
        return None if t is None else _cuda.ptr(t)

    def strided(g, cols):
        if g is None:
            return (None,) + (0,) * cols
        return (ptr(g),) + tuple(g.stride())

    outs = tuple(torch.empty(t.shape, dtype=f32, device=dev) for t in (
        xyz, saved.scales_raw, saved.rotations_raw, saved.opacities_raw,
        sh))
    valid = torch.zeros((), dtype=i32, device=dev)
    g_m, g_conic, g_op, g_col = grads
    with torch.cuda.device(dev):
        PREPROCESS_BWD(
            ptr(xyz), ptr(saved.scales_raw), ptr(saved.rotations_raw),
            ptr(saved.opacities_raw), ptr(sh), c, ptr(saved.degrees),
            ptr(saved.alive_mask), ptr(saved.radii), ptr(saved.depths),
            ptr(saved.rgb), ptr(saved.conic), ptr(cam.viewmatrix),
            ptr(cam.projmatrix),
            ptr(cam.campos), ptr(cam.tan_fovx), ptr(cam.tan_fovy), p,
            cam.width, cam.height, float(scale_modifier),
            *strided(g_m, 2), *strided(g_conic, 2), *strided(g_op, 1),
            *strided(g_col, 2), *map(ptr, outs), ptr(valid),
            _cuda.stream_of(xyz))
    profiling.count("preprocess_bwd", valid)
    return outs
