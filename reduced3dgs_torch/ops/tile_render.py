"""Tile rasterizer, forward (PyTorch + CUDA kernel K2).

Counterpart of the forward half of reduced3dgs_tpu/ops/tile_render.py
(f32 mode), with the same compositing semantics:

  power = -0.5 d^T conic d;  a lane is kept where power <= POWER_EPS
  alpha = min(0.99, opacity * exp(min(power, 0))),  skip if alpha < 1/255
  stop the pixel before a blend that would push T below 1e-4
  C += c * alpha * T;  T *= 1 - alpha

Instance features are feature-major (16, B_pad) rows [x, y, cxx, cxy, cyy,
op, r, g, b, 0...] gathered in binning's K-aligned slot order; the
per-pixel result is (num_tiles, 8, 256) rows [r, g, b, T_final, 0...],
empty tiles colour 0 and T 1.  The background is added outside.

K2 (csrc/tile_fwd.cu) walks one 16x16 tile per 256-thread block;
``tile_fwd_plain`` is its plain version, vectorised over tiles and
128-instance chunks (cumulative products along each chunk).
"""

from __future__ import annotations

import ctypes

import torch

from reduced3dgs_torch.ops import _cuda
from reduced3dgs_torch.ops.binning import ALIGN, BinningOut
from reduced3dgs_torch.ops.preprocess import (
    TILE_X, TILE_Y, PreprocessOut, tile_grid,
)

K = ALIGN  # = 128 instances per chunk / shared-memory batch
NPIX = TILE_X * TILE_Y  # 256 pixels per tile
FEAT_ROWS = 16  # packed feature rows per instance (9 live)
TABLE_ROWS = 9
PIX_ROWS = 8  # packed per-pixel rows: [r, g, b, T, 0, 0, 0, 0]
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1.0e-4
# Lanes are kept up to power <= POWER_EPS (not 0) and the exponent is
# clamped to <= 0, matching the JAX kernels (tile_render.py:99-107).
POWER_EPS = 1.0e-3
TILE_GROUP = 256  # tiles the plain version composites at once


# ---------------------------------------------------------------------------
# K2: forward compositing
# ---------------------------------------------------------------------------

TILE_FWD = _cuda.Kernel("tile_fwd", "tile_fwd_launch", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p])


def tile_fwd_plain(feat, ranges, limit, grid_x: int, width: int,
                   height: int, count_pairs: bool = False):
    """Plain version of K2.

    feat: (16, B_pad) f32; ranges: (2, num_tiles) int32 K-aligned
    [start, end); limit: () int32, no instance at or past it is read.
    Returns (num_tiles, 8, 256) f32; with count_pairs, also a dict of the
    (pixel, instance) pairs K2's sequential walk visits: "walked" (each
    pixel up to and including its stopping instance), "blended" (those
    that add colour) and "stopped" (pixels whose T would fall below
    T_EPS, one pair each), as Python ints.
    """
    num_tiles = ranges.shape[1]
    dev = feat.device
    b_pad = feat.shape[1]
    out = torch.zeros((num_tiles, PIX_ROWS, NPIX), dtype=torch.float32,
                      device=dev)
    out[:, 3, :] = 1.0
    starts = ranges[0].long()
    ends = torch.minimum(ranges[1].long(), limit.long())
    busy = torch.nonzero(ends > starts).flatten()
    lane = torch.arange(K, device=dev)
    pix = torch.arange(NPIX, device=dev)
    pairs = dict(walked=0, blended=0, stopped=0)
    for g0 in range(0, busy.numel(), TILE_GROUP):
        tiles = busy[g0:g0 + TILE_GROUP]
        s, e = starts[tiles], ends[tiles]
        px = (tiles % grid_x * TILE_X)[:, None] + pix % TILE_X  # (G,256)
        py = (tiles // grid_x * TILE_Y)[:, None] + pix // TILE_X
        done = (px >= width) | (py >= height)  # cropped pixels start done
        pxf = px.to(torch.float32)[:, :, None]
        pyf = py.to(torch.float32)[:, :, None]
        t_cur = torch.ones(px.shape, dtype=torch.float32, device=dev)
        acc = torch.zeros(px.shape + (3,), dtype=torch.float32, device=dev)
        n_chunks = int(((e - s + K - 1) // K).max())
        for c in range(n_chunks):
            if bool(done.all()):
                break
            idx = s[:, None] + c * K + lane  # (G, K)
            inr = idx < e[:, None]
            f = feat[:TABLE_ROWS, torch.clamp(idx, max=b_pad - 1)]  # (9,G,K)
            f = f[:, :, None, :]  # broadcast over pixels
            dx = f[0] - pxf
            dy = f[1] - pyf
            power = (-0.5 * (f[2] * dx * dx + f[4] * dy * dy)
                     - f[3] * dx * dy)  # (G, 256, K)
            opm = torch.where(inr[:, None, :], f[5], 0.0)
            g = torch.where(power <= POWER_EPS,
                            torch.exp(torch.clamp(power, max=0.0)), 0.0)
            alpha = torch.clamp(opm * g, max=ALPHA_CLAMP)
            live = alpha >= ALPHA_MIN
            a = torch.where(live, alpha, 0.0)
            t_inc = t_cur[..., None] * torch.cumprod(1.0 - a, dim=-1)
            t_exc = torch.cat([t_cur[..., None], t_inc[..., :-1]], dim=-1)
            contrib = live & ~done[..., None] & (t_inc >= T_EPS)
            w = torch.where(contrib, a * t_exc, 0.0)
            rgb = f[6:9, :, 0, :].permute(1, 2, 0)  # (G, K, 3)
            acc = acc + torch.bmm(w, rgb)
            t_cur = torch.where(contrib, t_inc, t_cur[..., None]).amin(-1)
            crossed = t_inc < T_EPS  # monotone along the chunk
            if count_pairs:
                stop = crossed[..., -1] & ~done
                first = crossed.to(torch.int32).argmax(dim=-1) + 1
                n_in = inr.sum(dim=-1)[:, None]
                need = torch.where(stop, first, n_in)
                pairs["walked"] += int(torch.where(done, 0, need).sum())
                pairs["blended"] += int(contrib.sum())
                pairs["stopped"] += int(stop.sum())
            done = done | crossed[..., -1]
        out[tiles, 0:3, :] = acc.permute(0, 2, 1)
        out[tiles, 3, :] = t_cur
    if count_pairs:
        return out, pairs
    return out


def _tile_fwd_cuda(feat, ranges, limit, grid_x: int, width: int,
                   height: int):
    num_tiles = ranges.shape[1]
    if feat.dtype != torch.float32 or feat.ndim != 2 \
            or feat.shape[0] < TABLE_ROWS or feat.stride(1) != 1:
        raise ValueError("tile_fwd: feat must be (>=9, B_pad) f32 rows")
    if ranges.dtype != torch.int32 or not ranges.is_contiguous() \
            or ranges.shape[0] != 2:
        raise ValueError("tile_fwd: ranges must be contiguous (2, T) int32")
    if limit.dtype != torch.int32 or limit.numel() != 1:
        raise ValueError("tile_fwd: limit must be one int32")
    for t in (ranges, limit):
        if t.device != feat.device:
            raise ValueError("tile_fwd: inputs must share one device")
    out = torch.empty((num_tiles, PIX_ROWS, NPIX), dtype=torch.float32,
                      device=feat.device)
    with torch.cuda.device(feat.device):
        TILE_FWD(_cuda.ptr(feat), feat.stride(0), _cuda.ptr(ranges),
                 num_tiles, _cuda.ptr(limit), grid_x, width, height,
                 _cuda.ptr(out), _cuda.stream_of(feat))
    return out


def tile_fwd(feat, ranges, limit, grid_x: int, width: int, height: int):
    """K2 dispatch: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor (no fallback between them)."""
    if feat.device.type == "cuda":
        return _tile_fwd_cuda(feat, ranges, limit, grid_x, width, height)
    if feat.device.type == "cpu":
        return tile_fwd_plain(feat, ranges, limit, grid_x, width, height)
    raise ValueError(f"tile_fwd: unsupported device {feat.device}")


# ---------------------------------------------------------------------------
# packing / assembly helpers
# ---------------------------------------------------------------------------

def _pack_features(binning: BinningOut):
    """Gather aligned instances into a feature-major (16, B_pad) f32 array
    (f32 mode) from binning's depth-rank feature table.  Padding slots
    pull rank 0's row but sit outside every tile's [start, end) range."""
    b_pad = binning.gauss_aligned.shape[0]
    feat = torch.zeros((FEAT_ROWS, b_pad), dtype=torch.float32,
                       device=binning.feat_rank.device)
    feat[:TABLE_ROWS] = binning.feat_rank[binning.gauss_id().long()].T
    return feat, b_pad


def _packed_to_images(packed, grid_x, grid_y, width, height):
    """(T, PIX_ROWS, 256) -> color (H,W,3), t_fin (H,W)."""
    img = packed.reshape(grid_y, grid_x, PIX_ROWS, TILE_Y, TILE_X)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        grid_y * TILE_Y, grid_x * TILE_X, PIX_ROWS)
    img = img[:height, :width]
    return img[:, :, 0:3], img[:, :, 3]


def _core_fwd(binning: BinningOut, width: int, height: int):
    """Packed (num_tiles, 8, 256) tile output of K2 for one binning."""
    grid_x, _ = tile_grid(width, height)
    feat, b_pad = _pack_features(binning)
    # clamp: under slack overflow total_padded may exceed b_pad (the host
    # redoes the frame, see renderer.py); nothing past b_pad is read
    limit = torch.clamp(binning.total_padded, max=b_pad).to(torch.int32)
    return tile_fwd(feat, binning.tile_ranges.contiguous(), limit, grid_x,
                    width, height)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def tile_render(prep: PreprocessOut, binning: BinningOut, background,
                width: int, height: int, want_transmittance: bool = False,
                tile_rows=None, grad_reduce: str = "f32"):
    """Tile-rendered image with reference-parity semantics.

    Returns (color (H,W,3), final_T (H,W), None, None); the last two are
    the transmittance outputs, which this slice does not port yet.
    """
    if want_transmittance:
        raise NotImplementedError(
            "want_transmittance (SH culling, kernel _trans_kernel) is not "
            "ported yet")
    if tile_rows is not None:
        raise NotImplementedError("strip rendering (tile_rows) is not "
                                  "ported yet")
    if grad_reduce != "f32":
        raise NotImplementedError(
            f"grad_reduce={grad_reduce!r}: only the f32 forward is ported")
    grid_x, grid_y = tile_grid(width, height)
    del prep  # its features rode the binning sort (binning.feat_rank)
    packed = _core_fwd(binning, width, height)
    color, t_fin = _packed_to_images(packed, grid_x, grid_y, width, height)
    bg = torch.as_tensor(background, dtype=torch.float32,
                         device=color.device)
    color = color + t_fin[:, :, None] * bg[None, None, :]
    return color, t_fin, None, None
