"""Tile rasterizer (PyTorch + CUDA kernels K2, K3, K4, K5 and K6).

Counterpart of reduced3dgs_tpu/ops/tile_render.py, with the same
compositing semantics:

  power = -0.5 d^T conic d;  a lane is kept where power <= POWER_EPS
  alpha = min(0.99, opacity * exp(min(power, 0))),  skip if alpha < 1/255
  stop the pixel before a blend that would push T below 1e-4
  C += c * alpha * T;  T *= 1 - alpha

Instance features are binning's depth-rank table (P, 9) f32 rows [x, y,
cxx, cxy, cyy, op, r, g, b], read for slot s of the K-aligned layout
through its rank gauss_aligned[s] (WalkFeatures): the kernels gather each
instance as they stage it, the plain versions walk the feature-major (9,
B_pad) table WalkFeatures.table() builds.  The per-pixel result is
(num_tiles, 8, 256) rows [r, g, b, T_final, 0...], empty tiles colour 0
and T 1.  The background is added outside.

Kernels, each with its plain version beside it (the CPU runs the plain
version; a CUDA tensor launches the kernel or raises):

  K2  csrc/tile_fwd.cu    forward compositing, one 16x16 tile per block
  K3  csrc/tile_bwd.cu    backward re-walk: per-instance gradients of the
                          9 features, written once per slot, as one
                          slot-major record of GRAD_REC floats
  K4  csrc/tile_trans.cu  inference-only walk for SH-band culling: per
                          slot, the sum of the transmittance before each
                          blend and the count of blending pixels
  K5  csrc/seg_reduce.cu  per-primitive sums of the 9 gradient rows
  K6  csrc/seg_reduce.cu  the same with each value rounded to bf16 first
                          (the sums of bf16x2-packed rows)

``_RasterizeCore`` is the autograd Function around them (the JAX
package's custom VJP): means2d, conic, opacity and colour in, packed tile
rows out.  A strip of tile rows (the multi-device path, tile_rows=) is
walked at a tile base: window tile t is image tile base + t, as
_tile_info(base + t) in the JAX kernels, in K2, K3, K4 and their plain
versions alike.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from reduced3dgs_torch.ops import _cuda
from reduced3dgs_torch.ops.binning import ALIGN, BinningOut
from reduced3dgs_torch.ops.preprocess import (
    TILE_X, TILE_Y, PreprocessOut, tile_grid,
)
from reduced3dgs_torch.utils import profiling

K = ALIGN  # = 128 instances per chunk / shared-memory batch
NPIX = TILE_X * TILE_Y  # 256 pixels per tile
TABLE_ROWS = 9  # feature / gradient rows per instance
PIX_ROWS = 8  # packed per-pixel rows: [r, g, b, T, 0, 0, 0, 0]
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1.0e-4
# Lanes are kept up to power <= POWER_EPS (not 0) and the exponent is
# clamped to <= 0, matching the JAX kernels (tile_render.py:99-107).
POWER_EPS = 1.0e-3
TILE_GROUP = 256  # tiles the plain versions walk at once
GRAD_REDUCE = ("f32", "bf16x2")
# u16 fixed-point scale of the fast table's opacity (tile_render.py:852)
OP_FIX = 65535.0
PACKED_ROWS = 5  # bf16x2 pairs of the 9 gradient rows (10th is padding)
# floats per slot of K3's output on the card: the 9 gradients and 3 zeros,
# 48 B, so that K5 / K6 fetch one instance with three 16-byte loads
GRAD_REC = 12


def _argtypes(*names):
    return [ctypes.c_void_p if n == "p" else ctypes.c_longlong if n == "l"
            else ctypes.c_int for n in names]


class WalkFeatures(NamedTuple):
    """What K2, K3 and K4 stage each instance from: row gauss_aligned[s]
    of the depth-rank table for slot s (a rank outside [0, P), the pad
    sentinel 2^31 - 1, reads row 0, as BinningOut.gauss_id()).  quantised
    (grad_reduce="bf16x2"): the opacity and blue as the JAX package's
    packed table carries them, u16 fixed point and bf16.  The kernels
    gather in their staging loads (csrc/tile_walk.cuh); table() is the
    plain twin of that staging."""

    feat_rank: torch.Tensor  # (P, 9) f32, depth-rank order
    gauss_aligned: torch.Tensor  # (B_pad,) int32 rank per slot
    quantised: bool = False

    @property
    def device(self):
        return self.feat_rank.device

    @property
    def b_pad(self) -> int:
        return self.gauss_aligned.shape[0]

    def table(self):
        """The feature-major (9, B_pad) f32 table the walks see: each
        slot's row, its opacity rint(op 65535) clamped to [0, 65535] times
        1/65535 and its blue rounded to bf16 (nearest even) when
        quantised, the other columns as they are."""
        rank = self.gauss_aligned.long()
        rank = torch.where((rank >= 0) & (rank < self.feat_rank.shape[0]),
                           rank, 0)
        rows = self.feat_rank[rank]
        if self.quantised:
            # through the u16 integer the packed column holds (-0.0 -> 0)
            opq = torch.clamp(torch.round(rows[:, 5] * OP_FIX), 0.0, OP_FIX)
            op = opq.to(torch.int32).to(torch.float32) * (1.0 / OP_FIX)
            blue = rows[:, 8].to(torch.bfloat16).to(torch.float32)
            rows = torch.cat([rows[:, 0:5], op[:, None], rows[:, 6:8],
                              blue[:, None]], dim=1)
        return rows.T.contiguous()


# ---------------------------------------------------------------------------
# shared plain-version chunk state
# ---------------------------------------------------------------------------

def _tile_pixels(tiles, grid_x, width, height, base=0):
    """Pixel coordinates of window tiles `tiles`, which lie at image tiles
    base + tiles (a strip's window starts at tile base = r0 * grid_x)."""
    pix = torch.arange(NPIX, device=tiles.device)
    tiles = tiles + base
    px = (tiles % grid_x * TILE_X)[:, None] + pix % TILE_X  # (G, 256)
    py = (tiles // grid_x * TILE_Y)[:, None] + pix // TILE_X
    done = (px >= width) | (py >= height)  # cropped pixels start done
    return (px.to(torch.float32)[:, :, None],
            py.to(torch.float32)[:, :, None], done)


def _chunk(feat, s, e, c, pxf, pyf, t_cur, done):
    """Blend state of chunk c of a group of tiles, (G, 256, K) arrays."""
    b_pad = feat.shape[1]
    lane = torch.arange(K, device=feat.device)
    idx = s[:, None] + c * K + lane  # (G, K)
    inr = idx < e[:, None]
    f = feat[:TABLE_ROWS, torch.clamp(idx, max=b_pad - 1)]  # (9, G, K)
    fb = f[:, :, None, :]  # broadcast over pixels
    dx = fb[0] - pxf
    dy = fb[1] - pyf
    power = (-0.5 * (fb[2] * dx * dx + fb[4] * dy * dy)
             - fb[3] * dx * dy)  # (G, 256, K)
    opm = torch.where(inr[:, None, :], fb[5], 0.0)
    g = torch.where(power <= POWER_EPS,
                    torch.exp(torch.clamp(power, max=0.0)), 0.0)
    alpha = torch.clamp(opm * g, max=ALPHA_CLAMP)
    live = alpha >= ALPHA_MIN
    a = torch.where(live, alpha, 0.0)
    t_inc = t_cur[..., None] * torch.cumprod(1.0 - a, dim=-1)
    t_exc = torch.cat([t_cur[..., None], t_inc[..., :-1]], dim=-1)
    contrib = live & ~done[..., None] & (t_inc >= T_EPS)
    return dict(idx=idx, inr=inr, f=f, dx=dx, dy=dy, g=g, a=a, t_inc=t_inc,
                t_exc=t_exc, contrib=contrib,
                w=torch.where(contrib, a * t_exc, 0.0),
                rgb=f[6:9].permute(1, 0, 2))  # (G, 3, K)


def _advance(st, t_cur):
    t_next = torch.where(st["contrib"], st["t_inc"],
                         t_cur[..., None]).amin(-1)
    crossed = st["t_inc"] < T_EPS  # monotone along the chunk
    return t_next, crossed


def _busy_tiles(ranges, limit):
    starts = ranges[0].long()
    ends = torch.minimum(ranges[1].long(), limit.long())
    return starts, ends, torch.nonzero(ends > starts).flatten()


# ---------------------------------------------------------------------------
# K2: forward compositing
# ---------------------------------------------------------------------------

# the staging arguments of K2 / K3 / K4: feat_rank, gauss_aligned, P, and
# whether to quantise
_STAGE_ARGS = ("p", "p", "i", "i")
TILE_FWD = _cuda.Kernel("tile_fwd", "tile_fwd_launch",
                        _argtypes(*_STAGE_ARGS, "p", "i", "p", "i", "i", "i",
                                  "i", "p", "p"))


def warp_pixels(warp_shape=(16, 2), pixels_per_thread: int = 1):
    """(warps, 32 * pixels_per_thread) tile pixels (py * 16 + px) each
    warp walks, as csrc/tile_walk.cuh:pixel_of maps them: 32 lanes cover
    a block of warp_shape = (wide, high) pixels, and a thread owns the
    same lane of pixels_per_thread neighbouring blocks."""
    ww, wh = warp_shape
    if ww * wh != 32 or TILE_X % ww or TILE_Y % wh:
        raise ValueError(f"32 lanes cannot cover {warp_shape} pixels")
    if pixels_per_thread not in (1, 2, 4):
        raise ValueError(f"{pixels_per_thread} pixels per thread")
    idx = torch.arange(NPIX)
    lane, block = idx % 32, idx // 32
    per_row = TILE_X // ww
    x = block % per_row * ww + lane % ww
    y = block // per_row * wh + lane // ww
    return (y * TILE_X + x).reshape(NPIX // 32 // pixels_per_thread,
                                    32 * pixels_per_thread)


def walk_layout(source: str) -> dict:
    """How csrc/<source>.cu ("tile_fwd", "tile_bwd" or "tile_trans") lays
    a tile out, as tile_fwd_plain's count_pairs keywords, read from the
    defaults in the sources: the (wide, high) pixel block of a warp's 32
    lanes (csrc/tile_walk.cuh WALK_WARP_W), the pixels per thread (K2 and
    K4 always one) and the instances staged at once."""
    tag = {"tile_fwd": "TILE_FWD", "tile_bwd": "TILE_BWD",
           "tile_trans": "TILE_TRANS"}[source]
    wide = _cuda.define_default("tile_walk.cuh", "WALK_WARP_W")
    return dict(
        warp_shape=(wide, 32 // wide),
        pixels_per_thread=(_cuda.define_default("tile_bwd.cu", "TILE_BWD_PPT")
                           if source == "tile_bwd" else 1),
        batch=_cuda.define_default(f"{source}.cu", f"{tag}_BATCH"))


def tile_fwd_plain(feat, ranges, limit, grid_x: int, width: int,
                   height: int, base: int = 0, count_pairs: bool = False,
                   warp_shape=(16, 2), pixels_per_thread: int = 1,
                   batch: int = K):
    """Plain version of K2.

    feat: (9, B_pad) f32; ranges: (2, num_tiles) int32 K-aligned
    [start, end); limit: () int32, no instance at or past it is read;
    base: the image tile of window tile 0 (r0 * grid_x for a strip of
    tile rows from r0).
    Returns (num_tiles, 8, 256) f32; with count_pairs, also a dict of the
    (pixel, instance) pairs K2's sequential walk visits: "walked" (each
    pixel up to and including its stopping instance), "blended" (those
    that add colour) and "stopped" (pixels whose T would fall below
    T_EPS, one pair each); of the (warp, instance) pairs for warps of
    warp_pixels(warp_shape, pixels_per_thread): "warp_walked" (a pixel of
    the warp still walks the instance, so the warp dispatches it) and
    "warp_blended" (a pixel of the warp blends it); and "staged", the
    instances a block loads in batches of `batch` (a divisor of 128)
    before its last pixel is done.  All Python ints.
    """
    if K % batch:
        raise ValueError(f"batch {batch} does not divide {K}")
    num_tiles = ranges.shape[1]
    dev = feat.device
    out = torch.zeros((num_tiles, PIX_ROWS, NPIX), dtype=torch.float32,
                      device=dev)
    out[:, 3, :] = 1.0
    starts, ends, busy = _busy_tiles(ranges, limit)
    pairs = dict(walked=0, blended=0, stopped=0, warp_walked=0,
                 warp_blended=0, staged=0)
    by_warp = (warp_pixels(warp_shape, pixels_per_thread).to(dev)
               if count_pairs else None)
    for g0 in range(0, busy.numel(), TILE_GROUP):
        tiles = busy[g0:g0 + TILE_GROUP]
        s, e = starts[tiles], ends[tiles]
        pxf, pyf, done = _tile_pixels(tiles, grid_x, width, height, base)
        t_cur = torch.ones(done.shape, dtype=torch.float32, device=dev)
        acc = torch.zeros(done.shape + (3,), dtype=torch.float32, device=dev)
        n_chunks = int(((e - s + K - 1) // K).max())
        for c in range(n_chunks):
            if bool(done.all()):
                break
            st = _chunk(feat, s, e, c, pxf, pyf, t_cur, done)
            acc = acc + torch.bmm(st["w"], st["rgb"].transpose(1, 2))
            t_cur, crossed = _advance(st, t_cur)
            if count_pairs:
                stop = crossed[..., -1] & ~done
                first = crossed.to(torch.int32).argmax(dim=-1) + 1
                n_in = st["inr"].sum(dim=-1)[:, None]
                # instances of the chunk each pixel walks: a prefix
                need = torch.where(done, 0, torch.where(stop, first, n_in))
                pairs["walked"] += int(need.sum())
                pairs["blended"] += int(st["contrib"].sum())
                pairs["warp_walked"] += int(
                    need[:, by_warp].amax(dim=2).sum())
                pairs["warp_blended"] += int(
                    st["contrib"][:, by_warp].any(dim=2).sum())
                pairs["stopped"] += int(stop.sum())
                longest = need.amax(dim=1, keepdim=True)
                pairs["staged"] += int(torch.minimum(
                    n_in, (longest + batch - 1) // batch * batch).sum())
            done = done | crossed[..., -1]
        out[tiles, 0:3, :] = acc.permute(0, 2, 1)
        out[tiles, 3, :] = t_cur
    if count_pairs:
        return out, pairs
    return out


def _check_walk_inputs(name, src: WalkFeatures, ranges, limit):
    fr, ga = src.feat_rank, src.gauss_aligned
    if fr.dtype != torch.float32 or fr.ndim != 2 \
            or fr.shape[1] != TABLE_ROWS or not fr.is_contiguous():
        raise ValueError(f"{name}: feat_rank must be contiguous (P, 9) f32")
    if ga.dtype != torch.int32 or ga.ndim != 1 or not ga.is_contiguous():
        raise ValueError(f"{name}: gauss_aligned must be contiguous (B_pad,) "
                         "int32")
    if ranges.dtype != torch.int32 or not ranges.is_contiguous() \
            or ranges.shape[0] != 2:
        raise ValueError(f"{name}: ranges must be contiguous (2, T) int32")
    if limit.dtype != torch.int32 or limit.numel() != 1:
        raise ValueError(f"{name}: limit must be one int32")
    for t in (ga, ranges, limit):
        if t.device != fr.device:
            raise ValueError(f"{name}: inputs must share one device")


def _stage_args(src: WalkFeatures):
    return (_cuda.ptr(src.feat_rank), _cuda.ptr(src.gauss_aligned),
            src.feat_rank.shape[0], int(src.quantised))


def _tile_fwd_cuda(src: WalkFeatures, ranges, limit, grid_x: int,
                   width: int, height: int, base: int = 0):
    _check_walk_inputs("tile_fwd", src, ranges, limit)
    num_tiles = ranges.shape[1]
    out = torch.empty((num_tiles, PIX_ROWS, NPIX), dtype=torch.float32,
                      device=src.device)
    with torch.cuda.device(src.device):
        TILE_FWD(*_stage_args(src), _cuda.ptr(ranges), num_tiles,
                 _cuda.ptr(limit), grid_x, base, width, height,
                 _cuda.ptr(out), _cuda.stream_of(src.feat_rank))
    return out


def tile_fwd(src: WalkFeatures, ranges, limit, grid_x: int, width: int,
             height: int, base: int = 0):
    """K2 dispatch: the CUDA kernel on CUDA tensors, the plain version on
    src.table() on the CPU (no fallback between them)."""
    if src.device.type == "cuda":
        return _tile_fwd_cuda(src, ranges, limit, grid_x, width, height,
                              base)
    if src.device.type == "cpu":
        return tile_fwd_plain(src.table(), ranges, limit, grid_x, width,
                              height, base)
    raise ValueError(f"tile_fwd: unsupported device {src.device}")


# ---------------------------------------------------------------------------
# K3: backward re-walk
# ---------------------------------------------------------------------------

TILE_BWD = _cuda.Kernel("tile_bwd", "tile_bwd_launch",
                        _argtypes(*_STAGE_ARGS, "p", "i", "p", "i", "i", "i",
                                  "i", "p", "p", "p", "i", "p"))


def tile_bwd_plain(feat, ranges, limit, grid_x: int, width: int,
                   height: int, g_packed, packed, base: int = 0):
    """Plain version of K3.

    feat/ranges/limit/base as K2; g_packed: (num_tiles, 8, 256) f32 cotangent
    of K2's output (rows dL/dC, dL/dT_final); packed: K2's output.
    Returns dfeat (9, B_pad) f32, the gradient of each slot's features;
    slots the walk never reaches are exactly 0.  Front-to-back, as the
    JAX kernel: dalpha = gc t_exc - (q - incl) / (1 - a) with gc = g.rgb,
    incl the running prefix of w gc and q = g.C + g_T T_final per pixel.
    """
    dev = feat.device
    dfeat = torch.zeros((TABLE_ROWS, feat.shape[1]), dtype=torch.float32,
                        device=dev)
    starts, ends, busy = _busy_tiles(ranges, limit)
    for g0 in range(0, busy.numel(), TILE_GROUP):
        tiles = busy[g0:g0 + TILE_GROUP]
        s, e = starts[tiles], ends[tiles]
        pxf, pyf, done = _tile_pixels(tiles, grid_x, width, height, base)
        gpix = g_packed[tiles]  # (G, 8, 256)
        spix = packed[tiles]
        gcol = gpix[:, 0:3, :].permute(0, 2, 1)  # (G, 256, 3)
        q = (gcol * spix[:, 0:3, :].permute(0, 2, 1)).sum(-1) \
            + gpix[:, 3, :] * spix[:, 3, :]  # (G, 256)
        t_cur = torch.ones(done.shape, dtype=torch.float32, device=dev)
        prefix = torch.zeros(done.shape, dtype=torch.float32, device=dev)
        n_chunks = int(((e - s + K - 1) // K).max())
        for c in range(n_chunks):
            if bool(done.all()):
                break
            st = _chunk(feat, s, e, c, pxf, pyf, t_cur, done)
            w, a, f = st["w"], st["a"], st["f"]
            gc = torch.bmm(gcol, st["rgb"])  # (G, 256, K)
            incl = prefix[..., None] + torch.cumsum(w * gc, dim=-1)
            # 1 - a >= 0.01 on every lane (a is clamped)
            dalpha = torch.where(
                st["contrib"],
                gc * st["t_exc"] - (q[..., None] - incl) / (1.0 - a), 0.0)
            ge = st["g"] * dalpha
            dpower = f[5][:, None, :] * ge
            dx, dy = st["dx"], st["dy"]
            cxx, cxy, cyy = (f[r][:, None, :] for r in (2, 3, 4))
            rows = [
                (-(cxx * dx + cxy * dy) * dpower).sum(1),
                (-(cyy * dy + cxy * dx) * dpower).sum(1),
                (-0.5 * dx * dx * dpower).sum(1),
                (-dx * dy * dpower).sum(1),
                (-0.5 * dy * dy * dpower).sum(1),
                ge.sum(1),
            ]
            dcol = torch.bmm(w.transpose(1, 2), gcol)  # (G, K, 3)
            vals = torch.cat([torch.stack(rows), dcol.permute(2, 0, 1)])
            inr = st["inr"]
            dfeat[:, st["idx"][inr]] = vals[:, inr]
            t_cur, crossed = _advance(st, t_cur)
            prefix = incl[..., -1]
            done = done | crossed[..., -1]
    return dfeat


def _tile_bwd_cuda(src: WalkFeatures, ranges, limit, grid_x: int,
                   width: int, height: int, g_packed, packed, base: int = 0):
    _check_walk_inputs("tile_bwd", src, ranges, limit)
    num_tiles = ranges.shape[1]
    shape = (num_tiles, PIX_ROWS, NPIX)
    for name, t in (("g_packed", g_packed), ("packed", packed)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != src.device:
            raise ValueError(f"tile_bwd: {name} must be contiguous "
                             f"{shape} f32 on the features' device")
    # zeros: slots the walk never reaches must read exactly 0.  One record
    # per slot (the layout K5 / K6 read); the caller sees its (9, B_pad)
    # transposed view, the same values as the plain version's rows.
    records = torch.zeros((src.b_pad, GRAD_REC), dtype=torch.float32,
                          device=src.device)
    with torch.cuda.device(src.device):
        TILE_BWD(*_stage_args(src), _cuda.ptr(ranges), num_tiles,
                 _cuda.ptr(limit), grid_x, base, width, height,
                 _cuda.ptr(g_packed), _cuda.ptr(packed), _cuda.ptr(records),
                 GRAD_REC, _cuda.stream_of(src.feat_rank))
    return records.T[:TABLE_ROWS]


def tile_bwd(src: WalkFeatures, ranges, limit, grid_x: int, width: int,
             height: int, g_packed, packed, base: int = 0):
    """K3 dispatch: the CUDA kernel on CUDA tensors, the plain version on
    src.table() on the CPU (no fallback between them)."""
    if src.device.type == "cuda":
        return _tile_bwd_cuda(src, ranges, limit, grid_x, width, height,
                              g_packed, packed, base)
    if src.device.type == "cpu":
        return tile_bwd_plain(src.table(), ranges, limit, grid_x, width,
                              height, g_packed, packed, base)
    raise ValueError(f"tile_bwd: unsupported device {src.device}")


# ---------------------------------------------------------------------------
# K4: per-instance transmittance statistics (feeds SH-band culling)
# ---------------------------------------------------------------------------

TILE_TRANS = _cuda.Kernel("tile_trans", "tile_trans_launch",
                          _argtypes(*_STAGE_ARGS, "p", "i", "p", "i", "i",
                                    "i", "i", "p", "l", "p"))


def tile_trans_plain(feat, ranges, limit, grid_x: int, width: int,
                     height: int, base: int = 0):
    """Plain version of K4.

    feat/ranges/limit/base as K2.  Returns (2, B_pad) f32 rows [trans_sum,
    touched]: per slot, over the tile's pixels that blend the instance,
    the sum of the transmittance before the blend and the number of those
    pixels.  The pair that stops a pixel adds nothing, and slots the walk
    never reaches are exactly 0.
    """
    dev = feat.device
    out = torch.zeros((2, feat.shape[1]), dtype=torch.float32, device=dev)
    starts, ends, busy = _busy_tiles(ranges, limit)
    for g0 in range(0, busy.numel(), TILE_GROUP):
        tiles = busy[g0:g0 + TILE_GROUP]
        s, e = starts[tiles], ends[tiles]
        pxf, pyf, done = _tile_pixels(tiles, grid_x, width, height, base)
        t_cur = torch.ones(done.shape, dtype=torch.float32, device=dev)
        n_chunks = int(((e - s + K - 1) // K).max())
        for c in range(n_chunks):
            if bool(done.all()):
                break
            st = _chunk(feat, s, e, c, pxf, pyf, t_cur, done)
            contrib = st["contrib"]
            vals = torch.stack([
                torch.where(contrib, st["t_exc"], 0.0).sum(1),
                contrib.sum(1).to(torch.float32)])  # (2, G, K)
            inr = st["inr"]
            out[:, st["idx"][inr]] = vals[:, inr]
            t_cur, crossed = _advance(st, t_cur)
            done = done | crossed[..., -1]
    return out


def _tile_trans_cuda(src: WalkFeatures, ranges, limit, grid_x: int,
                     width: int, height: int, base: int = 0):
    _check_walk_inputs("tile_trans", src, ranges, limit)
    # zeros: slots the walk never reaches must read exactly 0
    out = torch.zeros((2, src.b_pad), dtype=torch.float32,
                      device=src.device)
    with torch.cuda.device(src.device):
        TILE_TRANS(*_stage_args(src), _cuda.ptr(ranges), ranges.shape[1],
                   _cuda.ptr(limit), grid_x, base, width, height,
                   _cuda.ptr(out), out.stride(0),
                   _cuda.stream_of(src.feat_rank))
    return out


def tile_trans(src: WalkFeatures, ranges, limit, grid_x: int, width: int,
               height: int, base: int = 0):
    """K4 dispatch: the CUDA kernel on CUDA tensors, the plain version on
    src.table() on the CPU (no fallback between them)."""
    if src.device.type == "cuda":
        return _tile_trans_cuda(src, ranges, limit, grid_x, width, height,
                                base)
    if src.device.type == "cpu":
        return tile_trans_plain(src.table(), ranges, limit, grid_x, width,
                                height, base)
    raise ValueError(f"tile_trans: unsupported device {src.device}")


@torch.no_grad()
def transmittance_by_primitive(binning: BinningOut, width: int, height: int,
                               base: int = 0):
    """(trans_sum (P,) f32, touched (P,) int32) in original primitive
    order: K4 on the exact f32 features (whatever grad_reduce is), then a
    scatter-add per primitive.  The accumulators are all positive, so a
    direct sum per primitive keeps the precision the culling statistics
    need; padding slots and slots at or past total_padded go to a dump
    row.  base: as K2's (a strip's binning)."""
    src, ranges, limit, grid_x = _walk_inputs(binning, width, fast=False)
    acc = tile_trans(src, ranges, limit, grid_x, width, height, base)
    num_p = binning.prim_inv.shape[0]
    slot = torch.arange(src.b_pad, device=acc.device)
    seg_id = torch.where(binning.pad_mask | (slot >= binning.total_padded),
                         num_p, binning.gauss_aligned).long()
    asum = torch.zeros((num_p + 1, 2), dtype=torch.float32,
                       device=acc.device).index_add_(0, seg_id, acc.T)
    asum = asum[:num_p][binning.prim_inv.long()]  # depth rank -> original id
    return asum[:, 0], asum[:, 1].to(torch.int32)


# ---------------------------------------------------------------------------
# K5 / K6: per-primitive segmented sums
# ---------------------------------------------------------------------------

_SEG_ARGS = _argtypes("p", "l", "p", "p", "i", "p", "l", "p")
SEG_REDUCE_F32 = _cuda.Kernel("seg_reduce", "seg_reduce_f32_launch",
                              _SEG_ARGS)
SEG_REDUCE_PACKED = _cuda.Kernel("seg_reduce", "seg_reduce_packed_launch",
                                 _SEG_ARGS)


def unpack_bf16x2(v):
    """int32 rows of (bf16 hi << 16 | bf16 lo) -> (hi, lo) f32: widening a
    bf16 is appending 16 zero bits (hi = v & 0xFFFF0000, lo = v << 16)."""
    return (v & -65536).view(torch.float32), (v << 16).view(torch.float32)


def pack_bf16x2(a, b):
    """Two f32 rows -> one int32 row of (bf16(a) << 16 | bf16(b)),
    rounded to nearest even as the JAX package's astype(bfloat16)."""
    ah = a.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    bh = b.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    return (ah << 16) | bh  # ah's sign extension is shifted out


def through_bf16x2(vals):
    """(9, n) f32 -> the values a bf16x2 payload carries: the rows packed
    in pairs (the tenth value 0) and unpacked again, each rounded to bf16
    to nearest even."""
    n = vals.shape[1]
    vals = torch.cat([vals[:TABLE_ROWS], torch.zeros_like(vals[:1])])
    hi, lo = unpack_bf16x2(pack_bf16x2(vals[0::2], vals[1::2]))
    return torch.stack([hi, lo], dim=1).reshape(2 * PACKED_ROWS,
                                                n)[:TABLE_ROWS]


def as_records(rows, rec: int = GRAD_REC):
    """(>=9, B) f32 rows -> the same nine rows as the transposed view of a
    zero-padded (B, rec) array: K3's slot-major layout on the card, the
    only one K5 / K6 take there."""
    records = torch.zeros((rows.shape[1], rec), dtype=torch.float32,
                          device=rows.device)
    records[:, :TABLE_ROWS] = rows[:TABLE_ROWS].T
    return records.T[:TABLE_ROWS]


def seg_reduce_plain(rows, order, bounds, packed: bool):
    """Plain version of K5 (packed=False) and K6 (packed=True) on (>=9, B)
    f32 rows of any strides.  Segment r is order[bounds[r]:bounds[r+1]];
    returns the (9, P) f32 sums, P = len(bounds) - 1, in segment
    (depth-rank) order.  K6 sums what the JAX package's bf16x2 sort
    payload holds: the rows packed in pairs (pack_bf16x2, the tenth value
    0) and unpacked again, i.e. each value rounded to bf16 to nearest
    even (through_bf16x2)."""
    num_p = bounds.shape[0] - 1
    s0, n = int(bounds[0]), int(bounds[-1])
    vals = rows[:TABLE_ROWS, order[s0:n]]
    if packed:
        vals = through_bf16x2(vals)
    lens = (bounds[1:] - bounds[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_p, device=rows.device), lens, output_size=n - s0)
    out = torch.zeros((TABLE_ROWS, num_p), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(1, seg, vals)


def _seg_reduce_cuda(rows, order, bounds, packed: bool):
    if rows.ndim != 2 or rows.shape[0] < TABLE_ROWS \
            or rows.dtype != torch.float32 or rows.stride(0) != 1 \
            or rows.stride(1) < 12 or rows.stride(1) % 4 \
            or rows.data_ptr() % 16:
        raise ValueError(
            "seg_reduce: rows must be the (>=9, B) f32 transposed view of "
            "16-byte-aligned slot-major records of 12, 16, ... floats "
            "(tile_bwd's output on the card, or as_records)")
    if order.dtype != torch.int64 or order.ndim != 1 \
            or not order.is_contiguous() or order.shape[0] != rows.shape[1]:
        raise ValueError("seg_reduce: order must be a contiguous (B,) "
                         "int64 permutation")
    if bounds.dtype != torch.int32 or bounds.ndim != 1 \
            or not bounds.is_contiguous():
        raise ValueError("seg_reduce: bounds must be contiguous int32")
    for t in (order, bounds):
        if t.device != rows.device:
            raise ValueError("seg_reduce: inputs must share one device")
    num_p = bounds.shape[0] - 1
    out = torch.empty((TABLE_ROWS, num_p), dtype=torch.float32,
                      device=rows.device)
    kernel = SEG_REDUCE_PACKED if packed else SEG_REDUCE_F32
    with torch.cuda.device(rows.device):
        kernel(_cuda.ptr(rows), rows.stride(1), _cuda.ptr(order),
               _cuda.ptr(bounds), num_p, _cuda.ptr(out), out.stride(0),
               _cuda.stream_of(rows))
    return out


def seg_reduce(rows, order, bounds, packed: bool):
    """K5 / K6 dispatch: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor (no fallback between them)."""
    if rows.device.type == "cuda":
        return _seg_reduce_cuda(rows, order, bounds, packed)
    if rows.device.type == "cpu":
        return seg_reduce_plain(rows, order, bounds, packed)
    raise ValueError(f"seg_reduce: unsupported device {rows.device}")


def segment_order(binning: BinningOut):
    """The slots sorted on key = where(pad, P, depth rank): pads, slack
    and truncated slots sort past every real one, so depth rank r's
    instances are order[seg_bounds[r]:seg_bounds[r+1]]."""
    num_p = binning.seg_bounds.shape[0] - 1
    key = torch.where(binning.pad_mask, num_p, binning.gauss_aligned)
    return torch.sort(key, stable=True).indices


def segment_reduce_by_src(dfeat, binning: BinningOut, grad_reduce="f32"):
    """Per-primitive sums of the (9, B_pad) per-slot gradient rows (K3's
    output), (9, P) in original primitive order: the key sort, K5 (f32)
    or K6 (bf16x2: every value rounded to bf16 before it is added, the
    JAX package's packed sort payload), then the reorder from depth rank
    to primitive id."""
    if grad_reduce not in GRAD_REDUCE:
        raise ValueError(f"unknown grad_reduce {grad_reduce!r}")
    sums = seg_reduce(dfeat, segment_order(binning),
                      binning.seg_bounds.contiguous(),
                      packed=grad_reduce == "bf16x2")
    return sums[:, binning.prim_inv.long()]  # depth rank -> original id


# ---------------------------------------------------------------------------
# feature tables / assembly helpers
# ---------------------------------------------------------------------------

def _pack_features(binning: BinningOut, fast: bool = False):
    """The feature-major (9, B_pad) f32 table the walks see for a binning,
    and B_pad: the plain twin of the kernels' staging (WalkFeatures.table;
    fast: the bf16x2 table's values), bit for bit the JAX package's
    _pack_features.  Padding slots pull rank 0's row but sit outside every
    tile's [start, end) range."""
    src = WalkFeatures(binning.feat_rank, binning.gauss_aligned, fast)
    return src.table(), src.b_pad


def _packed_to_images(packed, grid_x, grid_y, width, height):
    """(T, PIX_ROWS, 256) -> color (H,W,3), t_fin (H,W)."""
    img = packed.reshape(grid_y, grid_x, PIX_ROWS, TILE_Y, TILE_X)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        grid_y * TILE_Y, grid_x * TILE_X, PIX_ROWS)
    img = img[:height, :width]
    return img[:, :, 0:3], img[:, :, 3]


def _walk_inputs(binning: BinningOut, width: int, fast: bool):
    """(WalkFeatures, ranges, limit, grid_x) of a binning: no table is
    built here, the walks stage from feat_rank themselves."""
    grid_x, _ = tile_grid(width, 1)
    src = WalkFeatures(binning.feat_rank, binning.gauss_aligned, fast)
    # clamp: under slack overflow total_padded may exceed b_pad (the host
    # redoes the frame, see renderer.py); nothing past b_pad is read
    limit = torch.clamp(binning.total_padded, max=src.b_pad).to(torch.int32)
    return src, binning.tile_ranges.contiguous(), limit, grid_x


def _core_fwd(binning: BinningOut, width: int, height: int,
              fast: bool = False):
    """Packed (num_tiles, 8, 256) tile output of K2 for one binning."""
    src, ranges, limit, grid_x = _walk_inputs(binning, width, fast)
    return tile_fwd(src, ranges, limit, grid_x, width, height)


class _RasterizeCore(torch.autograd.Function):
    """Packed tile rows with K3 + K5/K6 as the backward (the JAX package's
    custom VJP, tile_render.py:952).  The values come from
    binning.feat_rank (built from detached tensors), which both walks
    stage from, so no per-slot table is saved; the gradients go to the
    four differentiable inputs.  The backward marks the stage
    boundaries "tile_bwd" (K3), "reduce" (the key sort and K5 / K6) and
    "preprocess_bwd" (the rest of autograd, utils/profiling.py)."""

    @staticmethod
    def forward(ctx, means2d, conic, opacity, color, binning, width, height,
                grad_reduce, base):
        fast = grad_reduce == "bf16x2"
        src, ranges, limit, grid_x = _walk_inputs(binning, width, fast)
        packed = tile_fwd(src, ranges, limit, grid_x, width, height, base)
        ctx.save_for_backward(ranges, limit, packed)
        ctx.meta = (binning, src, grid_x, width, height, grad_reduce, base)
        return packed

    @staticmethod
    def backward(ctx, g_packed):
        ranges, limit, packed = ctx.saved_tensors
        binning, src, grid_x, width, height, grad_reduce, base = ctx.meta
        device = g_packed.device
        profiling.stage("tile_bwd", device)
        dfeat = tile_bwd(src, ranges, limit, grid_x, width, height,
                         g_packed.contiguous(), packed, base)
        profiling.stage("reduce", device)
        sums = segment_reduce_by_src(dfeat, binning, grad_reduce)
        profiling.stage("preprocess_bwd", device)
        return (sums[0:2].T, sums[2:5].T, sums[5], sums[6:9].T,
                None, None, None, None, None)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def tile_render(prep: PreprocessOut, binning: BinningOut, background,
                width: int, height: int, want_transmittance: bool = False,
                tile_rows=None, grad_reduce: str = "f32"):
    """Tile-rendered image with reference-parity semantics, differentiable
    in prep.means2d, conic, opacity and color.

    tile_rows=(r0, num_rows), two ints, renders only that strip of tile
    rows from the binning of the same window (bin_gaussians(tile_rows=)):
    exactly num_rows * 16 pixel rows from row r0 * 16, where rows past the
    image height composite to pure background (the caller crops them).

    Returns (color (h,W,3), final_T (h,W), trans_sum (P,) | None, touched
    (P,) int32 | None); the last two (want_transmittance, kernel K4) carry
    no gradient.
    """
    if grad_reduce not in GRAD_REDUCE:
        raise ValueError(f"unknown grad_reduce {grad_reduce!r}")
    grid_x, grid_y = tile_grid(width, height)
    r0, num_rows, crop_h = 0, grid_y, height
    if tile_rows is not None:
        r0, num_rows = tile_rows
        crop_h = num_rows * TILE_Y
    base = r0 * grid_x
    packed = _RasterizeCore.apply(prep.means2d, prep.conic, prep.opacity,
                                  prep.color, binning, width, height,
                                  grad_reduce, base)
    color, t_fin = _packed_to_images(packed, grid_x, num_rows, width,
                                     crop_h)
    bg = torch.as_tensor(background, dtype=torch.float32,
                         device=color.device)
    color = color + t_fin[:, :, None] * bg[None, None, :]
    g_trans = g_touch = None
    if want_transmittance:
        g_trans, g_touch = transmittance_by_primitive(binning, width, height,
                                                      base)
    return color, t_fin, g_trans, g_touch
