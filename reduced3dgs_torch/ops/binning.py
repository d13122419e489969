"""Tile binning (PyTorch): instance expansion, depth order, tile ranges.

Counterpart of reduced3dgs_tpu/ops/binning.py, bit-identical in every
``BinningOut`` field for the same ``PreprocessOut``.  Under a static
instance budget B:

  * primitives are renumbered in depth order first (one stable P-sized
    sort on the f32 depth bits viewed as int32), so within a tile depth
    order equals rank order,
  * per-tile instance counts come from a 2-D difference array over the
    tile grid (integer-exact), plus the row-major partial rect of the one
    primitive the budget splits,
  * the K-aligned relocation (every tile's range starts at a multiple of
    ALIGN) rides the ONE B-sized sort, on an int64 key tile*(P+1)+rank:
    synthetic padding instances carry (tile, P) keys and sort into each
    tile's alignment slack,
  * kernel K1 (csrc/expand.cu) writes every slot's key in one launch:
    instance slot -> owning primitive ("expand") and pad slot -> tile, by
    binary search; its plain version ``bin_keys_plain`` computes the same
    keys the JAX package's way (``expand_stream``, a marker scatter and a
    running max).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reduced3dgs_torch.ops import _cuda
from reduced3dgs_torch.ops.preprocess import PreprocessOut, tile_grid

ALIGN = 128  # must equal tile_render.K (kernel batch width)
CHUNK_GROUP = 8  # B_pad is a multiple of ALIGN*CHUNK_GROUP
_MAXI = 2**31 - 1  # pad-slot sentinel in gauss_aligned


class BinningOut(NamedTuple):
    gauss_aligned: torch.Tensor  # (B_pad,) int32 depth-rank id per slot
    tile_id: torch.Tensor  # (B_pad,) int32 tile per aligned slot
    tile_ranges: torch.Tensor  # (2, num_tiles) int32 [start; end), K-aligned
    num_rendered: torch.Tensor  # () int32 true instance count (may exceed B)
    total_padded: torch.Tensor  # () int32 end of the written aligned region
    seg_bounds: torch.Tensor  # (P+1,) int32 per-rank expand segment bounds
    prim_order: torch.Tensor  # (P,) int32 original primitive id per rank
    prim_inv: torch.Tensor  # (P,) int32 depth rank per original id
    feat_rank: torch.Tensor | None = None  # (P, 9) f32 render features
    # [x2d, y2d, cxx, cxy, cyy, op, r, g, b] in depth-rank order

    @property
    def pad_mask(self):
        """(B_pad,) bool, True where the slot is padding."""
        return self.gauss_aligned == _MAXI

    def gauss_id(self):
        """(B_pad,) depth-rank primitive id per slot (padding -> id 0)."""
        return torch.where(self.pad_mask, 0, self.gauss_aligned)


def _slack_pool(num_tiles: int) -> int:
    stat = (num_tiles * 80 + int(148 * math.sqrt(num_tiles)) + 256)
    return min(num_tiles * ALIGN, stat)


def padded_size(budget: int, width: int, height: int,
                tile_rows=None) -> int:
    """B_pad of a binning at `budget`; tile_rows=(r0, num_rows): of that
    window of tile rows (its slack pool sized by the window's tiles)."""
    gx, gy = tile_grid(width, height)
    rows = gy if tile_rows is None else tile_rows[1]
    budget = -(-budget // ALIGN) * ALIGN  # keep B_pad a multiple of K
    size = budget + _slack_pool(gx * rows)
    group = ALIGN * CHUNK_GROUP
    return -(-size // group) * group


def depth_key(depths):
    """f32 depth -> int32 key with the same order for positive depths."""
    return depths.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# _expand_stream's counterpart (the JAX package's K1; the reference only)
# ---------------------------------------------------------------------------

def expand_marks_plain(pos, rank1, rect, budget: int):
    """Mark scatter + running max, the JAX ``_expand_kernel``'s function.

    pos: (n,) int32 nondecreasing mark positions (entries >= budget are
    not marks); rank1/rect: (n,) int32 values per mark.  Returns (3,
    budget) int32 rows (rank1 - 1, rect, pos) of the last mark with
    position <= slot, and (-1, 0, 0) before the first mark.
    """
    n = pos.shape[0]
    dev = pos.device
    if n == 0:
        return torch.tensor([-1, 0, 0], dtype=torch.int32,
                            device=dev)[:, None].expand(3, budget).clone()
    marked = pos < budget
    last = torch.zeros(budget, dtype=torch.int64, device=dev)
    idx1 = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, pos[marked].long(), idx1[marked], "amax")
    last = torch.cummax(last, dim=0).values - 1  # mark index, -1 before
    safe = torch.clamp(last, min=0)
    has = last >= 0
    out = torch.stack([
        torch.where(has, rank1.long()[safe] - 1, -1),
        torch.where(has, rect.long()[safe], 0),
        torch.where(has, pos.long()[safe], 0),
    ]).to(torch.int32)
    return out


def compact_marks(mark_pos, rank1, rectpack, budget: int):
    """Marked rows (mark_pos < budget) to the front in rank order; the
    rest get position INT32_MAX so a search never lands on them.  The
    marks' positions must be nondecreasing in rank order (true for
    primitive start offsets)."""
    p = mark_pos.shape[0]
    marked = mark_pos < budget
    iota = torch.arange(p, dtype=torch.int32, device=mark_pos.device)
    order = torch.sort(torch.where(marked, iota, p)).indices
    pos_c = torch.where(marked[order], mark_pos[order], _MAXI)
    return (pos_c.to(torch.int32).contiguous(), rank1[order].contiguous(),
            rectpack[order].contiguous())


def expand_stream(mark_pos, rank1, rectpack, budget: int):
    """Counterpart of the JAX _expand_stream: (gauss_c, rect_c, start_c)
    over `budget` slots — the (rank1 - 1, rectpack, mark position) of the
    last marked row at or before each slot, (-1, 0, 0) before any."""
    out = expand_marks_plain(*compact_marks(mark_pos, rank1, rectpack,
                                            budget), budget)
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# K1: the slot keys of the one B_pad-sized sort
# ---------------------------------------------------------------------------

EXPAND = _cuda.Kernel("expand", "bin_keys_launch", [
    _cuda.ctypes.c_void_p, _cuda.ctypes.c_void_p, _cuda.ctypes.c_void_p,
    _cuda.ctypes.c_int, _cuda.ctypes.c_void_p, _cuda.ctypes.c_int,
    _cuda.ctypes.c_void_p, _cuda.ctypes.c_int, _cuda.ctypes.c_int,
    _cuda.ctypes.c_int, _cuda.ctypes.c_void_p, _cuda.ctypes.c_void_p])


def bin_keys_plain(offsets, counts, rectpack, pad_start, nv, grid_x: int,
                   budget: int, b_pad: int):
    """Plain version of K1: the (B_pad,) int64 sort key of every slot,
    tile * (P+1) + rank.  The first `budget` slots hold the instances in
    rank order; pad slot k belongs to the tile whose cumulative padding
    need covers k (rank P).  Slot nv + j (at or past nv: no instance)
    holds pad n_extra + j (n_extra = b_pad - budget, the slack pool) when
    every pad fits in B_pad (nv + pad need <= b_pad), and is unused
    otherwise or past the pads: tile num_tiles, rank P.

    offsets/counts/rectpack: (P,) int32 in depth-rank order (inclusive
    prefix sums of the counts, the counts, the rect words); pad_start:
    (T+1,) int32 exclusive prefix sums of each tile's padding need; nv:
    () int32 instances that fit.  Computed as the JAX package does: the
    instance -> primitive expand of _expand_stream, then a marker scatter
    and running max for the padding (the sentinel num_tiles marks the end
    of all real padding).  Where the pads fit in the slack pool the keys
    are the JAX package's, bit for bit; the spill into the unused slots
    is this port's (the JAX package drops those pads).
    """
    p = offsets.shape[0]
    num_tiles = pad_start.shape[0] - 1
    n_extra = b_pad - budget
    dev = offsets.device
    i32 = torch.int32

    slot = torch.arange(budget, dtype=i32, device=dev)
    starts_all = offsets - counts
    mark_pos = torch.where(counts > 0, starts_all, budget).to(i32)
    gauss_c, rect_c, start_c = expand_stream(
        mark_pos, torch.arange(1, p + 1, dtype=i32, device=dev), rectpack,
        budget)

    # rank within the primitive's rect -> tile, row-major over the rect
    rank = slot - start_c
    rw = (rect_c & 1023) + 1
    ty = ((rect_c >> 10) & 1023) + torch.div(rank, rw, rounding_mode="floor")
    tx = (rect_c >> 20) + torch.remainder(rank, rw)
    tile = ty * grid_x + tx
    in_range = slot < nv
    tile = torch.where(in_range, tile, num_tiles).to(i32)

    pad_counts = pad_start[1:] - pad_start[:-1]
    pmark = torch.cat([pad_counts > 0,
                       torch.ones(1, dtype=torch.bool, device=dev)])
    # the marker pass runs over pads 0 .. b_pad - 1: pad k < n_extra has
    # a pad slot of its own, pad k >= n_extra may spill (below); markers
    # at or past b_pad land in one extra slot that is cut off (a clamp,
    # not a mask, so the host never syncs)
    pmark_pos = torch.clamp(torch.where(pmark, pad_start, b_pad), max=b_pad)
    pmarkers = torch.zeros(b_pad + 1, dtype=torch.int64, device=dev)
    pmarkers.scatter_reduce_(
        0, pmark_pos.long(),
        torch.arange(num_tiles + 1, dtype=torch.int64, device=dev), "amax")
    pad_tile = torch.cummax(pmarkers[:b_pad], dim=0).values

    # pads past the slack pool spill into the budget's unused slots: pad
    # n_extra + j goes to slot nv + j, when the whole layout fits (nv +
    # pad need <= b_pad); else those slots stay unused and the layout is
    # the JAX package's (renderer.py reports it as an overflow)
    fits = nv + pad_start[-1] <= b_pad
    spill_k = torch.clamp(n_extra + slot - nv, min=0, max=b_pad - 1)
    spilled = fits & ~in_range
    tile = torch.where(spilled, pad_tile[spill_k], tile)

    pp1 = p + 1
    key = (tile.long() * pp1
           + torch.where(in_range, gauss_c, p).long())
    key_pad = pad_tile[:n_extra] * pp1 + p
    return torch.cat([key, key_pad])


def _bin_keys_cuda(offsets, counts, rectpack, pad_start, nv, grid_x: int,
                   budget: int, b_pad: int):
    for t in (offsets, counts, rectpack, pad_start, nv):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("bin_keys: inputs must be contiguous int32")
        if t.device != offsets.device:
            raise ValueError("bin_keys: inputs must share one device")
    p = offsets.shape[0]
    if counts.shape != (p,) or rectpack.shape != (p,) or nv.numel() != 1 \
            or pad_start.ndim != 1 or pad_start.shape[0] < 1 \
            or not 0 <= budget <= b_pad:
        raise ValueError("bin_keys: (P,) offsets / counts / rectpack, "
                         "(T+1,) pad_start, one nv, budget <= b_pad")
    keys = torch.empty(b_pad, dtype=torch.int64, device=offsets.device)
    with torch.cuda.device(offsets.device):
        EXPAND(_cuda.ptr(offsets), _cuda.ptr(counts), _cuda.ptr(rectpack), p,
               _cuda.ptr(pad_start), pad_start.shape[0] - 1, _cuda.ptr(nv),
               grid_x, budget, b_pad, _cuda.ptr(keys),
               _cuda.stream_of(offsets))
    return keys


def bin_keys(offsets, counts, rectpack, pad_start, nv, grid_x: int,
             budget: int, b_pad: int):
    """K1 dispatch: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor (no fallback between them)."""
    args = (offsets, counts, rectpack, pad_start, nv, grid_x, budget, b_pad)
    if offsets.device.type == "cuda":
        return _bin_keys_cuda(*args)
    if offsets.device.type == "cpu":
        return bin_keys_plain(*args)
    raise ValueError(f"bin_keys: unsupported device {offsets.device}")


# ---------------------------------------------------------------------------
# bin_gaussians
# ---------------------------------------------------------------------------

def _tile_counts(x0, x1, y0, y1, include, grid_x, grid_y):
    """(grid_y, grid_x) int64 count of included rects covering each tile,
    by a 2-D difference array (integer-exact)."""
    dev = x0.device
    diff = torch.zeros((grid_y + 1) * (grid_x + 1), dtype=torch.int64,
                       device=dev)
    inc = include.long()
    stride = grid_x + 1
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_add_(0, (yy.long() * stride + xx.long()), inc * sign)
    d2 = diff.reshape(grid_y + 1, grid_x + 1)
    return torch.cumsum(torch.cumsum(d2, dim=0), dim=1)[:grid_y, :grid_x]


def bin_gaussians(prep: PreprocessOut, width: int, height: int,
                  budget: int, tile_rows=None) -> BinningOut:
    """Build the sorted, K-aligned per-tile instance lists.

    budget: static instance capacity B (pre-alignment).  num_rendered
    reports the true instance count, which may exceed it (truncation).
    tile_rows: (r0, num_rows), two ints: bin only the tiles of rows
    [r0, r0 + num_rows) (a strip of the multi-device path), with tile ids
    local to the window; the window may reach past the last tile row.
    The rects' rows are clipped to the window and shifted by -r0, so the
    rest is the binning of a num_rows-row frame (K1's launch included).
    """
    budget = -(-budget // ALIGN) * ALIGN
    grid_x, grid_y = tile_grid(width, height)
    r0, grid_y = (0, grid_y) if tile_rows is None else tile_rows
    num_tiles = grid_x * grid_y
    p = prep.tiles_touched.shape[0]
    dev = prep.tiles_touched.device
    i32 = torch.int32

    def i32t(v):
        return torch.tensor(v, dtype=i32, device=dev)

    rx0, ry0 = prep.rect_min[:, 0], prep.rect_min[:, 1]
    rx1, ry1 = prep.rect_max[:, 0], prep.rect_max[:, 1]
    if tile_rows is not None:
        ry0 = torch.clamp(ry0, r0, r0 + grid_y) - r0
        ry1 = torch.clamp(ry1, r0, r0 + grid_y) - r0
    # gate on the validity-masked tiles_touched: raw rects of culled
    # primitives are stale and would emit phantom instances
    counts0 = torch.where(
        prep.tiles_touched > 0,
        torch.clamp((rx1 - rx0) * (ry1 - ry0), min=0), 0).to(i32)
    rpack0 = ((rx0 << 20) | (ry0 << 10)
              | (torch.clamp(rx1 - rx0, min=1) - 1)).to(i32)

    # --- depth renumbering: stable sort on the depth bits -------------
    order = torch.sort(depth_key(prep.depths.detach()), stable=True).indices
    rectpack = rpack0[order]
    counts = counts0[order]
    # detached (the JAX package's stop_gradient): the renderer's autograd
    # Function carries the gradients of these nine columns
    feat_rank = torch.cat(
        [prep.means2d, prep.conic, prep.opacity[:, None], prep.color],
        dim=1).detach()[order].to(torch.float32)
    prim_inv = torch.empty(p, dtype=i32, device=dev)
    prim_inv[order] = torch.arange(p, dtype=i32, device=dev)

    rw_p = (rectpack & 1023) + 1
    x0 = rectpack >> 20
    y0 = (rectpack >> 10) & 1023
    x1 = torch.where(counts > 0, x0 + rw_p, x0)
    y1 = y0 + torch.where(counts > 0, torch.div(counts, rw_p,
                                                rounding_mode="floor"), 0)
    offsets = torch.cumsum(counts, dim=0, dtype=i32)  # inclusive
    num_rendered = offsets[-1] if p > 0 else i32t(0)
    nv = torch.clamp(num_rendered, max=budget)

    # --- per-tile counts ----------------------------------------------
    full = offsets <= nv  # every instance of the primitive fits
    count2d = _tile_counts(x0, x1, y0, y1, full & (counts > 0),
                           grid_x, grid_y)
    # at most one boundary primitive is split by the budget: its first q
    # instances (row-major over its rect) are included
    if p > 0:
        p_star = full.sum()
        # gathered by index_select: indexing with a 0-dim tensor would
        # read it on the host (a sync, and no CUDA graph capture)
        ps = torch.clamp(p_star, max=p - 1).reshape(1)
        xs0, xs1, ys0, off_ps, cnt_ps = torch.stack(
            [x0, x1, y0, offsets, counts]).index_select(1, ps)[:, 0]
        q = nv - (off_ps - cnt_ps)
        has_partial = (p_star < p) & (q > 0) & (cnt_ps > 0)
        w = torch.clamp(xs1 - xs0, min=1)
        fr = torch.div(q, w, rounding_mode="floor")
        rem = q - fr * w
        iy = torch.arange(grid_y, dtype=i32, device=dev)
        ix = torch.arange(grid_x, dtype=i32, device=dev)
        yfull = ((iy >= ys0) & (iy < ys0 + fr)).long()
        xfull = ((ix >= xs0) & (ix < xs1)).long()
        yrow = (iy == ys0 + fr).long()
        xrem = ((ix >= xs0) & (ix < xs0 + rem)).long()
        corr = yfull[:, None] * xfull[None, :] + yrow[:, None] * xrem[None, :]
        count2d = count2d + has_partial.long() * corr
    tcounts = count2d.reshape(num_tiles).to(i32)

    # --- K-aligned relocation rides the one sort ----------------------
    padded = ((tcounts + ALIGN - 1) // ALIGN) * ALIGN
    csum_padded = torch.cumsum(padded, dim=0, dtype=i32)
    new_start = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                           csum_padded[:-1]])
    total_padded = csum_padded[-1] if num_tiles > 0 else i32t(0)
    b_pad = padded_size(budget, width, height, tile_rows)
    # synthetic padding instances: each tile's padding need, as prefix sums
    pad_start = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                           torch.cumsum(padded - tcounts, dim=0, dtype=i32)])

    # ONE sort over B_pad on the int64 key tile*(P+1) + rank (K1 writes
    # the keys); pads and truncated slots carry rank P and sort past every
    # real instance of their tile.  No ties among real instances.
    pp1 = p + 1
    key_a = torch.sort(bin_keys(
        offsets, counts.contiguous(), rectpack.contiguous(), pad_start,
        nv.reshape(1).contiguous(), grid_x, budget, b_pad)).values
    tile_a = torch.div(key_a, pp1, rounding_mode="floor")
    gauss_u = key_a - tile_a * pp1
    gauss_a = torch.where(gauss_u == p, _MAXI, gauss_u).to(i32)
    tile_a = tile_a.to(i32)

    seg_bounds = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                            torch.clamp(offsets, max=nv)])

    # slack-overflow safety: clamp ranges inside the (16, b_pad) array;
    # renderer.py folds total_padded > b_pad into num_rendered
    starts = torch.clamp(new_start, max=b_pad)
    ends = torch.clamp(new_start + tcounts, max=b_pad)
    return BinningOut(
        gauss_aligned=gauss_a,
        tile_id=tile_a,
        tile_ranges=torch.stack([starts, ends], dim=0).to(i32),
        num_rendered=num_rendered.to(i32),
        total_padded=total_padded.to(i32),
        seg_bounds=seg_bounds.to(i32),
        prim_order=order.to(i32),
        prim_inv=prim_inv,
        feat_rank=feat_rank,
    )
