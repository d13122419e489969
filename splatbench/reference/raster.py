"""Plain PyTorch reference of one splatting render: projection, tile
binning, front-to-back compositing, and its gradient by autograd.

Written for the benchmark from the published method (Kerbl et al., 3D
Gaussian Splatting, SIGGRAPH 2023, and its reference rasterizer) with
the conventions of the system under test: row-vector camera matrices,
16x16 tiles, and a primitive binned only to the tiles that the bounding
box of its alpha >= 1/300 level set touches, cut at 3 sigma.  Per pixel:

  alpha = min(0.99, opacity * exp(min(power, 0)));  skipped if < 1/255
  the walk stops before a blend that would push T below 1e-4
  colour = sum c_i alpha_i T_i + T_final * background

It imports nothing of the program.  It computes in the precision of its
inputs: float32, or bfloat16 for the control.  The image is
composited in chunks of tiles padded to their longest instance list, so
that memory stays bounded at published scene sizes; the gradient
recomputes each chunk under autograd (`render_backward`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
LEVEL = 300.0  # binning level set: alpha >= 1 / LEVEL
NEAR = 0.2
LOW_PASS = 0.3
CHUNK_PAIRS = 1 << 25  # (pixel, instance) pairs composited at once

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Camera(NamedTuple):
    """A camera: the transposed world-to-view and full projection
    matrices (row vectors: p_view = (p, 1) @ view), its centre, the
    tangents of the half fields of view and the image size."""
    view: torch.Tensor  # (4, 4)
    proj: torch.Tensor  # (4, 4)
    centre: torch.Tensor  # (3,)
    tan_x: float
    tan_y: float
    width: int
    height: int


def sh_basis(d):
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, SH_C0),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy)], dim=1)


def sh_colour(sh, xyz, centre, degrees):
    """(P, 16, 3) coefficients, each primitive's bands up to its own
    degree, seen from `centre`: RGB + 0.5, clamped at 0."""
    d = xyz - centre[None, :]
    d = d / torch.clamp(d.norm(dim=1, keepdim=True), min=1e-12)
    band = torch.arange(16, device=xyz.device).float().sqrt().floor()
    keep = (band[None, :] <= degrees[:, None].float()).to(sh.dtype)
    basis = sh_basis(d) * keep
    return torch.clamp((basis[:, :, None] * sh).sum(1) + 0.5, min=0.0)


class Projected(NamedTuple):
    xy: torch.Tensor  # (P, 2) pixel centres
    depth: torch.Tensor  # (P,)
    conic: torch.Tensor  # (P, 3) inverse 2D covariance (xx, xy, yy)
    opacity: torch.Tensor  # (P,) sigmoid, 0 where culled
    colour: torch.Tensor  # (P, 3)
    radius: torch.Tensor  # (P,) int64, 0 where culled
    rect: torch.Tensor  # (P, 4) int64 tiles x0, y0, x1, y1 (ends excluded)


def _tiles(v, grid):
    return torch.clamp(torch.floor(v), 0, grid).long()


def project(xyz, sh, scaling, rotation, opacity, degrees, alive, cam: Camera):
    """Per-primitive 2D splats from raw parameters (log scales, raw
    quaternions, pre-sigmoid opacities) and SH coefficients up to each
    primitive's own degree."""
    dt = xyz.dtype
    gx = -(-cam.width // TILE)
    gy = -(-cam.height // TILE)
    fx = cam.width / (2.0 * cam.tan_x)
    fy = cam.height / (2.0 * cam.tan_y)
    pv = xyz @ cam.view[:3, :3] + cam.view[3, :3]
    z = pv[:, 2]
    live = (z > NEAR) & alive
    one = torch.ones((), dtype=dt, device=xyz.device)
    zs = torch.where(live, z, one)
    xs = torch.where(live, pv[:, 0], 0 * one)
    ys = torch.where(live, pv[:, 1], 0 * one)
    hom = xyz @ cam.proj[:3, :] + cam.proj[3, :]
    w = 1.0 / torch.where(live, hom[:, 3] + 1e-7, one)
    px = ((hom[:, 0] * w + 1.0) * cam.width - 1.0) * 0.5
    py = ((hom[:, 1] * w + 1.0) * cam.height - 1.0) * 0.5

    q = rotation / torch.clamp(rotation.norm(dim=1, keepdim=True),
                               min=1e-12)
    r, a, b, c = q.unbind(1)
    rot = torch.stack([
        1 - 2 * (b * b + c * c), 2 * (a * b - r * c), 2 * (a * c + r * b),
        2 * (a * b + r * c), 1 - 2 * (a * a + c * c), 2 * (b * c - r * a),
        2 * (a * c - r * b), 2 * (b * c + r * a), 1 - 2 * (a * a + b * b),
    ], 1).reshape(-1, 3, 3)
    m = rot * torch.exp(scaling)[:, None, :]
    sigma = m @ m.transpose(1, 2)

    lx, ly = 1.3 * cam.tan_x, 1.3 * cam.tan_y
    tx = torch.clamp(xs / zs, -lx, lx) * zs
    ty = torch.clamp(ys / zs, -ly, ly) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([
        torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], 1),
        torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], 1)], 1)
    t = jac @ cam.view[:3, :3].T[None]  # (P, 2, 3)
    cov = t @ sigma @ t.transpose(1, 2)
    cxx = cov[:, 0, 0] + LOW_PASS
    cxy = cov[:, 0, 1]
    cyy = cov[:, 1, 1] + LOW_PASS
    det = cxx * cyy - cxy * cxy
    ok = live & (det != 0)
    inv = 1.0 / torch.where(ok, det, one)
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], 1)

    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    radius = torch.where(ok, radius, 0 * one)
    sq = torch.stack([_tiles((px - radius) / TILE, gx),
                      _tiles((py - radius) / TILE, gy),
                      _tiles((px + radius + TILE - 1) / TILE, gx),
                      _tiles((py + radius + TILE - 1) / TILE, gy)], 1)
    valid = ok & ((sq[:, 2] - sq[:, 0]) * (sq[:, 3] - sq[:, 1]) > 0)

    op = torch.sigmoid(opacity)
    r2 = torch.clamp(2.0 * torch.log(LEVEL * torch.clamp(op, min=1e-30)),
                     0.0, 9.0)
    ex = torch.minimum(torch.sqrt(r2 * torch.clamp(cxx, min=0.0)), radius)
    ey = torch.minimum(torch.sqrt(r2 * torch.clamp(cyy, min=0.0)), radius)
    rect = torch.stack([_tiles((px - ex) / TILE, gx),
                        _tiles((py - ey) / TILE, gy),
                        _tiles((px + ex + TILE - 1) / TILE, gx),
                        _tiles((py + ey + TILE - 1) / TILE, gy)], 1)
    binned = valid & (op * LEVEL >= 1.0)
    rect = torch.where(binned[:, None], rect, 0)
    colour = sh_colour(sh, xyz, cam.centre, degrees)
    vf = valid.to(dt)
    return Projected(
        xy=torch.stack([px, py], 1), depth=z, conic=conic * vf[:, None],
        opacity=op * vf, colour=colour * vf[:, None],
        radius=torch.where(valid, radius, 0 * one).long(), rect=rect)


class Bins(NamedTuple):
    prim: torch.Tensor  # (N,) primitive of each instance, tile-major
    start: torch.Tensor  # (tiles,) first instance of each tile
    count: torch.Tensor  # (tiles,) instances of each tile


def bin_tiles(p: Projected, width: int, height: int) -> Bins:
    """Every (tile, primitive) instance, ordered by tile and, within a
    tile, by depth (ties by primitive index)."""
    gx = -(-width // TILE)
    gy = -(-height // TILE)
    dev = p.xy.device
    nx = p.rect[:, 2] - p.rect[:, 0]
    ny = p.rect[:, 3] - p.rect[:, 1]
    n = nx * ny
    rank = torch.empty_like(n)
    order = torch.sort(p.depth.float(), stable=True).indices
    rank[order] = torch.arange(n.numel(), device=dev)
    prims = torch.nonzero(n > 0)[:, 0]
    counts = n[prims]
    prim = torch.repeat_interleave(prims, counts)
    first = torch.cumsum(counts, 0) - counts
    local = (torch.arange(prim.numel(), device=dev)
             - torch.repeat_interleave(first, counts))
    tile = ((p.rect[prim, 1] + local // nx[prim]) * gx
            + p.rect[prim, 0] + local % nx[prim])
    key = tile * n.numel() + rank[prim]
    sort = torch.sort(key).indices
    prim = prim[sort]
    count = torch.bincount(tile, minlength=gx * gy)
    start = torch.cumsum(count, 0) - count
    return Bins(prim, start, count)


def _chunks(bins: Bins, pairs: int = CHUNK_PAIRS):
    """Tiles in groups of similar instance counts: (tile ids, K)."""
    order = torch.sort(bins.count, descending=True).indices
    counts = bins.count[order].tolist()
    i = 0
    while i < len(order):
        k = max(counts[i], 1)
        j = i + max(1, pairs // (TILE * TILE * k))
        yield order[i:j], k
        i = j


def _composite(tiles, k, bins: Bins, xy, conic, opacity, colour, bg,
               width: int, height: int, count_pairs: bool = False):
    """Colour (n, 256, 3) and final T (n, 256) of a chunk of tiles;
    with count_pairs also the chunk's blended pairs, stopped pixels and
    walked pairs (each pixel's instances up to and including its stop)."""
    dev = xy.device
    dt = xy.dtype
    gx = -(-width // TILE)
    slot = torch.arange(k, device=dev)
    have = slot[None, :] < bins.count[tiles][:, None]  # (n, K)
    idx = torch.where(have, bins.start[tiles][:, None] + slot[None, :], 0)
    prim = bins.prim[idx] if bins.prim.numel() else torch.zeros_like(idx)
    lin = torch.arange(TILE * TILE, device=dev)
    pxf = ((tiles % gx)[:, None] * TILE + lin[None, :] % TILE).to(dt)
    pyf = ((tiles // gx)[:, None] * TILE + lin[None, :] // TILE).to(dt)
    dx = xy[prim, 0][:, None, :] - pxf[:, :, None]  # (n, 256, K)
    dy = xy[prim, 1][:, None, :] - pyf[:, :, None]
    cn = conic[prim]
    power = (-0.5 * (cn[..., 0][:, None, :] * dx * dx
                     + cn[..., 2][:, None, :] * dy * dy)
             - cn[..., 1][:, None, :] * dx * dy)
    alpha = torch.clamp(opacity[prim][:, None, :]
                        * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    hit = have[:, None, :] & (alpha >= ALPHA_MIN)
    a = torch.where(hit, alpha, torch.zeros((), dtype=dt, device=dev))
    keep = torch.cumprod(1.0 - a, dim=2)  # T after each instance
    blend = hit & (keep >= T_MIN)
    t_before = keep / (1.0 - a)
    wgt = torch.where(blend, a * t_before, torch.zeros((), dtype=dt,
                                                       device=dev))
    col = torch.einsum("npk,nkc->npc", wgt, colour[prim])
    t_end = torch.where(blend, keep, torch.ones((), dtype=dt,
                                                device=dev)).amin(dim=2)
    out = col + t_end[..., None] * bg
    if not count_pairs:
        return out, t_end, None
    with torch.no_grad():
        inside = ((pxf < width) & (pyf < height))[..., None]
        stop = hit & (keep < T_MIN) & inside
        stopped = stop.any(2)
        walked = torch.where(stopped, stop.float().argmax(2) + 1,
                             bins.count[tiles][:, None])
        counts = (int((blend & inside).sum()), int(stopped.sum()),
                  int(torch.where(inside[..., 0], walked, 0).sum()))
    return out, t_end, counts


def _pixels(tiles, width, height):
    gx = -(-width // TILE)
    lin = torch.arange(TILE * TILE, device=tiles.device)
    px = (tiles % gx)[:, None] * TILE + lin[None, :] % TILE
    py = (tiles // gx)[:, None] * TILE + lin[None, :] // TILE
    inside = (px < width) & (py < height)
    return py.clamp(max=height - 1), px.clamp(max=width - 1), inside


def composite(p: Projected, bins: Bins, bg, width: int, height: int,
              count_pairs: bool = False):
    """The whole image (H, W, 3); with count_pairs also the (blended
    pairs, stopped pixels, walked pairs) over the image's pixels."""
    img = torch.zeros((height, width, 3), dtype=p.xy.dtype,
                      device=p.xy.device)
    totals = [0, 0, 0]
    for tiles, k in _chunks(bins):
        out, _, counts = _composite(tiles, k, bins, p.xy, p.conic, p.opacity,
                                    p.colour, bg, width, height, count_pairs)
        py, px, inside = _pixels(tiles, width, height)
        img[py[inside], px[inside]] = out[inside]
        if counts is not None:
            totals = [t + c for t, c in zip(totals, counts)]
    return (img, tuple(totals)) if count_pairs else img


def render_backward(p: Projected, leaves, bins: Bins, bg, width: int,
                    height: int, grad_img):
    """Accumulate d(loss)/d(leaves) given d(loss)/d(image): `leaves` are
    (xy, conic, opacity, colour) tensors that require grad, of which `p`
    holds detached copies; each chunk of tiles is composited again under
    autograd and its pixels' gradient pulled back."""
    for tiles, k in _chunks(bins):
        out, _, _ = _composite(tiles, k, bins, *leaves, bg, width, height)
        py, px, inside = _pixels(tiles, width, height)
        g = torch.where(inside[..., None], grad_img[py, px],
                        torch.zeros((), dtype=grad_img.dtype,
                                    device=grad_img.device))
        torch.autograd.backward(out, g)


def counts(p: Projected, bins: Bins, pairs) -> dict:
    """What the roofline yardstick counts of one view: instances, binned
    primitives, and composite's (blended pairs, stopped pixels, walked
    pairs)."""
    area = (p.rect[:, 2] - p.rect[:, 0]) * (p.rect[:, 3] - p.rect[:, 1])
    blended, stopped, walked = pairs
    return dict(instances=int(bins.prim.numel()), binned=int((area > 0).sum()),
                blended=blended, stopped=stopped, walked=walked)


def pad_share(bins: Bins) -> float:
    """The alignment padding a 128-aligned tile layout needs, over the
    program's slack pool for it (ops/binning.py:_slack_pool at commit
    d31b96e: 80 slots a tile, 148 sqrt(tiles) and 256 more, at most 128
    a tile).  Above 1 the program's binning drops pads (PERF.md, Open
    questions); a diagnostic beside each comparison, not a check."""
    tiles = bins.count.numel()
    need = int(((-bins.count) % 128).sum())
    pool = min(tiles * 128, tiles * 80 + int(148 * math.sqrt(tiles)) + 256)
    return need / pool

