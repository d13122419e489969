"""K-nearest-neighbour search (PyTorch).

Counterpart of reduced3dgs_tpu/ops/knn.py (the reference's simple-knn:
distCUDA2 for the scale init, distIndex2 for the redundancy metric):

  * ``knn_exact``: a blocked brute-force search, O(P^2); candidates are
    selected on the expanded form |q|^2 - 2 q.c + |c|^2 (a matrix product
    per block of queries) and the selected neighbours' squared distances
    are recomputed by direct subtraction, as the JAX package does;
  * the certified blocked search (``_blocked_knn``) for large P: Morton
    sort, blocks of _BOX points, and per query block its own block plus a
    shortlist of the m blocks nearest to any of its queries; a query is
    certified when no unscanned block's AABB is closer than its k-th
    neighbour, and the host reruns with the next shortlist size of
    _M_LADDER until every query is certified (one host read per rung),
    then falls back to brute force with a RuntimeWarning;
  * ``_window_knn``: the approximate Morton-window sweep (opt-in);
  * on a card, above EXACT_LIMIT, ``_knn_cuda``: csrc/knn.cu, an exact
    search over Morton-ordered blocks of 32 points in one launch (the
    ladder's rungs took 3.5-10 s each at the 2.94M rows of a 2^22 pool and
    none certified); distances by direct subtraction, ties to the lower
    row, as its plain version ``knn_sorted_plain`` (brute force).  It is
    built for k = 3 (distCUDA2) and 30 (the redundancy metric) and refuses
    any other k with a RuntimeError.

``knn(points, k)`` auto-selects: brute force up to EXACT_LIMIT points,
above it the kernel on a card and the certified blocked search (the JAX
package's rule) elsewhere.  Rows with
non-finite coordinates are "absent" (the padding of a compacted pool):
both exact searches run on the real rows only, so an absent row is never
a neighbour while a real other point is left, and its own lists mean
nothing (distance inf).  The JAX package's brute force lets absent rows
into real points' lists where inf - inf forms NaN; the port does not
copy that.

The blocked search takes a chunk of query blocks per torch operation
(batched (blocks, box, (m+1) box) distance tensors sized by device type)
where the JAX package scans one block per step.

Where the card's search departs from the JAX package's arithmetic: the
JAX brute force (and its blocked search) chooses the neighbours on the
expanded form |q|^2 - 2 q.c + |c|^2 and then recomputes the chosen
ones' distances by direct subtraction; csrc/knn.cu (and
knn_sorted_plain) chooses on (dx dx + dy dy) + dz dz itself, rounded
after every operation.  So the two lists differ only where the k-th and
(k+1)-th distances lie within the expanded form's cancellation, about
2^-23 |q|^2 apart: such a row swaps one near tie for another at the
list's end, and its distances agree within float32 rounding.  Exact ties
go to the lower row on the card; JAX's top_k breaks them by position in
its candidate order.  tests/test_torch_knn.py holds the plain version to
the JAX package on points without near ties.
"""

from __future__ import annotations

import ctypes
import warnings

import torch

from reduced3dgs_torch.ops import _cuda
from reduced3dgs_torch.utils import profiling

EXACT_LIMIT = 32768  # brute force up to this many points
K_NEAREST = 3
# query rows x candidates per distance block, by device type
_PAIRS_PER_BLOCK = {"cpu": 1 << 24, "cuda": 1 << 27}
# Morton block size and the shortlist sizes tried until certified (the
# JAX package's values, knn.py:282-291)
_BOX = 256
_M_LADDER = (16, 32, 64, 96, 160, 256)
_U32 = 0xFFFFFFFF


def _pairs(device) -> int:
    return _PAIRS_PER_BLOCK.get(device.type, 1 << 24)


# ---------------------------------------------------------------------------
# exact brute force
# ---------------------------------------------------------------------------

def _knn_real(points, k: int):
    """knn_exact on finite points."""
    p = points.shape[0]
    q_rows = max(1, _pairs(points.device) // max(p, 1))
    sq = (points * points).sum(-1)
    idx_all = torch.arange(p, device=points.device)
    dists, idxs = [], []
    for q0 in range(0, p, q_rows):
        q = points[q0:q0 + q_rows]
        d2 = sq[q0:q0 + q_rows, None] - 2.0 * q @ points.T + sq[None, :]
        d2[torch.arange(q.shape[0], device=q.device),
           idx_all[q0:q0 + q_rows]] = torch.inf
        kk = min(k, p)
        best = torch.topk(d2, kk, dim=1, largest=False)
        dists.append(best.values)
        idxs.append(best.indices)
    best_d = torch.cat(dists) if dists else points.new_zeros((0, k))
    best_i = torch.cat(idxs) if idxs else idx_all.new_zeros((0, k))
    if best_d.shape[1] < k:  # fewer than k other points
        pad = k - best_d.shape[1]
        best_d = torch.cat([best_d, best_d.new_full((p, pad), torch.inf)], 1)
        best_i = torch.cat([best_i, best_i.new_zeros((p, pad))], 1)
    d2 = ((points[best_i] - points[:, None, :]) ** 2).sum(-1)
    return torch.where(torch.isfinite(best_d), d2, best_d), best_i


def _on_real_rows(points, k: int, search):
    """search(real_points, k) -> (d2, idx) run on the finite rows only;
    absent rows get distance inf and, where a list runs out of real
    neighbours, the first absent row as index."""
    finite = torch.isfinite(points).all(dim=-1)
    if bool(finite.all()):
        return search(points, k)
    p = points.shape[0]
    real = torch.nonzero(finite).flatten()
    gone = torch.nonzero(~finite).flatten()[0]
    d_r, i_r = search(points[real], k)
    dist = points.new_full((p, k), torch.inf)
    idx = gone.expand(p, k).clone()
    dist[real] = d_r
    idx[real] = torch.where(torch.isfinite(d_r), real[i_r], gone)
    return dist, idx


def knn_exact(points, k: int):
    """(P, k) squared distances and int64 indices of the k nearest other
    points (ascending).  Where fewer than k real other points exist the
    rest of the row has distance inf (and lists an absent row if there is
    one); an absent row's own lists are all inf."""
    return _on_real_rows(points, k, _knn_real)


# ---------------------------------------------------------------------------
# Morton codes and the approximate window sweep
# ---------------------------------------------------------------------------

def _expand_bits_10(v):
    """Spread 10 bits to every 3rd position: the JAX package's uint32
    arithmetic in int64, wrapped to 32 bits after each multiply."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton_codes(points, offset: float = 0.0):
    """30-bit Morton codes (int64, the JAX package's uint32 values) over
    the bbox of the finite rows; `offset` shifts the quantisation grid by
    that many cells.  Non-finite rows land in the top cell."""
    fin = torch.isfinite(points).all(dim=1, keepdim=True)
    lo = torch.where(fin, points, torch.inf).amin(dim=0)
    hi = torch.where(fin, points, -torch.inf).amax(dim=0)
    q = torch.clamp((points - lo) / torch.clamp(hi - lo, min=1e-12)
                    * 1023.0 + offset, 0, 1023)
    q = q.to(torch.int64)
    return (_expand_bits_10(q[:, 0]) | (_expand_bits_10(q[:, 1]) << 1)
            | (_expand_bits_10(q[:, 2]) << 2)) & _U32


# Orderings of the window sweep: (axis permutation, grid offset)
_ORDERINGS = (
    ((0, 1, 2), 0.0),
    ((0, 1, 2), 341.0),
    ((0, 1, 2), 682.0),
    ((2, 0, 1), 170.0),
)


def _window_candidates(points, order, window: int):
    """(P, 2W) candidate original ids and squared distances for one
    ordering: the W points before and after each point in `order`."""
    p = points.shape[0]
    dev = points.device
    sp = points[order]
    off = torch.cat([torch.arange(-window, 0, device=dev),
                     torch.arange(1, window + 1, device=dev)])
    idx = torch.arange(p, device=dev)[:, None] + off[None, :]
    ok = (idx >= 0) & (idx < p)
    idx_c = torch.clamp(idx, 0, p - 1)
    d2 = ((sp[idx_c] - sp[:, None, :]) ** 2).sum(-1)
    d2 = torch.where(ok, d2, torch.inf)
    cand = torch.zeros((p, off.shape[0]), dtype=torch.int64, device=dev)
    cand[order] = order[idx_c]
    dist = torch.full((p, off.shape[0]), torch.inf, device=dev)
    dist[order] = d2
    return cand, dist


def _window_knn(points, k: int, window: int):
    """Approximate (P, k): +-window sweeps over several Morton orderings,
    the deduplicated union, the k nearest (ties to the lower position, as
    the JAX package's top_k)."""
    cands, dists = [], []
    for perm, offset in _ORDERINGS:
        codes = morton_codes(points[:, list(perm)], offset)
        order = torch.sort(codes, stable=True).indices
        c, d = _window_candidates(points, order, window)
        cands.append(c)
        dists.append(d)
    cand = torch.cat(cands, dim=1)
    dist = torch.cat(dists, dim=1)
    # lexicographic sort on (id, dist): each id's first occurrence
    # carries its best distance, then repeats are killed
    dist, by_d = torch.sort(dist, dim=1, stable=True)
    cand = cand.gather(1, by_d)
    cand_s, by_c = torch.sort(cand, dim=1, stable=True)
    dist_s = dist.gather(1, by_c)
    dup = torch.cat([torch.zeros_like(cand_s[:, :1], dtype=torch.bool),
                     cand_s[:, 1:] == cand_s[:, :-1]], dim=1)
    dist_s = torch.where(dup, torch.inf, dist_s)
    best, sel = torch.sort(dist_s, dim=1, stable=True)
    return best[:, :k], cand_s.gather(1, sel[:, :k])


# ---------------------------------------------------------------------------
# certified blocked search
# ---------------------------------------------------------------------------

def _blocked_knn_step(points, k: int, m: int, box: int):
    """One rung of the blocked exact search.

    Returns (d2 (P, k), idx (P, k) int64, certified: a 0-dim bool tensor
    on the device, True iff no block outside any query's scanned set is
    closer than its k-th neighbour, so the result is exact)."""
    p = points.shape[0]
    dev = points.device
    if p <= box:
        # fewer than two blocks: brute force is the blocked search
        d2, idx = knn_exact(points, k)
        return d2, idx, torch.ones((), dtype=torch.bool, device=dev)
    order = torch.sort(morton_codes(points), stable=True).indices
    pad = (-p) % box
    sp = torch.cat([points[order],
                    points.new_full((pad, 3), torch.inf)])
    nb = sp.shape[0] // box
    m = max(min(m, nb - 1), 1)
    blocks = sp.reshape(nb, box, 3)
    fin = torch.isfinite(blocks[:, :, :1])
    bmin = torch.where(fin, blocks, torch.inf).amin(dim=1)  # (NB, 3)
    bmax = torch.where(fin, blocks, -torch.inf).amax(dim=1)
    lane = torch.arange(box, device=dev)
    all_blocks = torch.arange(nb, device=dev)
    # query blocks per chunk: the largest intermediates are the AABB
    # distances (G, S, NB, 3) and the candidate distances (G, S, (m+1)S)
    per_block = max(3 * box * nb, box * (m + 1) * box)
    g_max = max(1, _pairs(dev) // per_block)
    d2s, idxs = [], []
    certified = torch.ones((), dtype=torch.bool, device=dev)
    for qb0 in range(0, nb, g_max):
        qb = torch.arange(qb0, min(qb0 + g_max, nb), device=dev)  # (G,)
        g = qb.shape[0]
        q = blocks[qb]  # (G, S, 3)
        qslot = qb[:, None] * box + lane  # (G, S)
        # squared point-to-AABB distance to every block: (G, S, NB)
        d = torch.maximum(bmin - q[:, :, None, :], q[:, :, None, :] - bmax)
        dbox = torch.square(torch.clamp(d, min=0.0)).sum(-1)
        dbox = torch.where(torch.isnan(dbox), torch.inf, dbox)
        own = all_blocks[None, :] == qb[:, None]  # (G, NB)
        # shortlist: the m blocks nearest to any query of the block, own
        # block excluded (ties to the lower block id, as top_k)
        bscore = torch.where(own, torch.inf, dbox.amin(dim=1))
        short = torch.sort(bscore, dim=1, stable=True).indices[:, :m]
        cslot = torch.cat([qslot[:, None, :],
                           short[:, :, None] * box + lane], dim=1)
        cslot = cslot.reshape(g, (m + 1) * box)  # (G, C)
        c = sp[cslot]  # (G, C, 3)
        d2 = ((q * q).sum(-1, keepdim=True) - 2.0 * q @ c.transpose(1, 2)
              + (c * c).sum(-1)[:, None, :])  # (G, S, C)
        d2 = torch.clamp(d2, min=0.0)
        d2 = torch.where((cslot[:, None, :] == qslot[:, :, None])
                         | ~torch.isfinite(d2), torch.inf, d2)
        nd, sel = torch.topk(d2, k, dim=2, largest=False)  # (G, S, k)
        del d2
        # the selected distances by direct subtraction (the expanded form
        # cancels for tight clusters off the origin)
        csel = c.gather(1, sel.reshape(g, box * k, 1).expand(-1, -1, 3))
        d2sel = torch.square(csel.reshape(g, box, k, 3)
                             - q[:, :, None, :]).sum(-1)
        d2sel = torch.where(torch.isfinite(nd), d2sel, torch.inf)
        # k-th bound: only a row with k finite candidates bounds its true
        # k-th; a finite query with fewer keeps +inf (fails), a row with
        # none (a pad) passes
        fin_sel = torch.isfinite(d2sel)
        d2sel_max = torch.where(fin_sel, d2sel, -torch.inf).amax(dim=2)
        kth = torch.where(fin_sel.sum(2) >= k, d2sel_max,
                          torch.where(fin_sel.any(2), torch.inf,
                                      -torch.inf))
        scanned = own.clone()
        scanned.scatter_(1, short, True)
        ok = torch.where(scanned[:, None, :], torch.inf,
                         dbox).amin(dim=2) >= kth
        ok = ok | ~torch.isfinite(q[:, :, 0])
        certified = certified & ok.all()
        slots = torch.clamp(cslot.gather(1, sel.reshape(g, box * k)),
                            max=p - 1)
        d2s.append(d2sel.reshape(g * box, k))
        idxs.append(order[slots].reshape(g * box, k))
    d2s = torch.cat(d2s)[:p]
    idxs = torch.cat(idxs)[:p]
    d2o = torch.empty_like(d2s)
    d2o[order] = d2s
    idxo = torch.empty_like(idxs)
    idxo[order] = idxs
    return d2o, idxo, certified


def _blocked_knn(points, k: int, box: int = _BOX):
    """Certified-exact blocked search: rerun with the next shortlist size
    until certified (one host read per rung), else brute force with a
    RuntimeWarning.  Host counters: knn_certified_blocks.m<m>, the query
    blocks the certifying rung (shortlist size m) certified (the
    certificate is the whole search's, so every block certifies at one
    rung), or knn_fallback_rows, the rows brute force answers."""
    for m in _M_LADDER:
        d2, idx, ok = _blocked_knn_step(points, k, m, box)
        if bool(ok):
            profiling.add(f"knn_certified_blocks.m{m}",
                          -(-points.shape[0] // box))
            return d2, idx
    profiling.add("knn_fallback_rows", points.shape[0])
    warnings.warn(
        f"blocked KNN shortlist ladder {_M_LADDER} exhausted without an "
        f"exactness certificate for {points.shape[0]} points; falling "
        "back to O(P^2) brute force", RuntimeWarning, stacklevel=2)
    return _knn_real(points, k)


# ---------------------------------------------------------------------------
# the card's exact search (csrc/knn.cu)
# ---------------------------------------------------------------------------

KNN = _cuda.Kernel("knn", "knn_launch", [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
_KERNEL_BOX = 32  # points a block of the kernel, blocks a super-block


def sq_dist(a, b):
    """Squared distances (dx dx + dy dy) + dz dz, rounded after every
    operation: csrc/knn.cu's arithmetic (broadcasting a against b)."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def sorted_rows(points, q0: int, q1: int, k: int):
    """knn_sorted_plain's queries q0:q1: their k least sq_dist to every
    other point and those points' rows, ascending by (distance, row)."""
    d2 = sq_dist(points[q0:q1, None, :], points[None, :, :])
    q = torch.arange(d2.shape[0], device=d2.device)
    d2[q, q + q0] = torch.inf
    # ascending by distance; a stable sort keeps ties in row order
    d2, by = torch.sort(d2, dim=1, stable=True)
    return d2[:, :k], by[:, :k]


def knn_sorted_plain(points, k: int, rows: int = 1024):
    """Plain version of csrc/knn.cu on finite points: (P, k) squared
    distances (sq_dist) and int64 rows of the k nearest other points,
    ascending by (distance, row); +inf and -1 where fewer than k exist.
    Brute force, `rows` queries at a time."""
    p = points.shape[0]
    ids = torch.arange(p, device=points.device)
    d_out, i_out = [], []
    for q0 in range(0, p, rows):
        d2, by = sorted_rows(points, q0, q0 + rows, k)
        d_out.append(d2)
        i_out.append(by)
    d2 = torch.cat(d_out) if d_out else points.new_zeros((0, k))
    idx = torch.cat(i_out) if i_out else ids.new_zeros((0, k))
    if d2.shape[1] < k:  # fewer than k other points
        pad = k - d2.shape[1]
        d2 = torch.cat([d2, d2.new_full((p, pad), torch.inf)], 1)
        idx = torch.cat([idx, idx.new_full((p, pad), -1)], 1)
    return d2, torch.where(torch.isinf(d2), -1, idx)


def _boxes(blocks):
    """(n, 6) min xyz, max xyz of each (n, m, 3) group's finite points
    (+inf, -inf where it has none)."""
    fin = torch.isfinite(blocks[..., :1])
    return torch.cat([torch.where(fin, blocks, torch.inf).amin(dim=1),
                      torch.where(fin, blocks, -torch.inf).amax(dim=1)], 1)


def _knn_cuda(points, k: int):
    """csrc/knn.cu on finite points: the Morton order, its blocks' and
    super-blocks' boxes, one launch; the blocks the warps scanned go to
    the device counter knn_scanned_blocks.  k other than 3 or 30 is
    refused (RuntimeError from the launch)."""
    p = points.shape[0]
    dev = points.device
    box = _KERNEL_BOX
    order = torch.sort(morton_codes(points), stable=True).indices
    pad = (-p) % box
    sp = torch.cat([points[order].float(),
                    points.new_full((pad, 3), torch.inf)]).contiguous()
    orig = torch.cat([order.to(torch.int32),
                      torch.full((pad,), -1, dtype=torch.int32,
                                 device=dev)])
    nb = sp.shape[0] // box
    boxes = _boxes(sp.reshape(nb, box, 3))
    ns = -(-nb // box)
    spare = torch.tensor([torch.inf] * 3 + [-torch.inf] * 3, device=dev)
    grouped = torch.cat([boxes, spare.expand(ns * box - nb, 6)])
    grouped = grouped.reshape(ns, box, 6)
    sboxes = torch.cat([grouped[..., :3].amin(dim=1),
                        grouped[..., 3:].amax(dim=1)], 1).contiguous()
    boxes = boxes.contiguous()
    d2 = torch.empty((p, k), dtype=torch.float32, device=dev)
    idx = torch.empty((p, k), dtype=torch.int64, device=dev)
    scanned = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KNN(_cuda.ptr(sp), _cuda.ptr(orig), _cuda.ptr(boxes),
            _cuda.ptr(sboxes), nb, ns, k, _cuda.ptr(d2), _cuda.ptr(idx),
            _cuda.ptr(scanned), _cuda.stream_of(sp))
    profiling.count("knn_scanned_blocks", scanned[0])
    return d2, idx


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def knn(points, k: int, window: int = 64, exact: bool | None = None):
    """(P, k) squared distances and int64 indices of the k nearest
    neighbours.  exact=None auto-selects: brute force up to EXACT_LIMIT
    points, above it csrc/knn.cu on a card and the certified blocked
    search elsewhere (each on the real rows only); exact=True is brute
    force, exact=False the approximate Morton window sweep."""
    if exact is None and points.shape[0] > EXACT_LIMIT:
        search = _knn_cuda if points.device.type == "cuda" else _blocked_knn
        return _on_real_rows(points, k, search)
    if exact is False:
        return _window_knn(points, k, window)
    return knn_exact(points, k)


def knn_indices(points, k: int, **kw):
    """distIndex2: the neighbour indices only."""
    return knn(points, k, **kw)[1]


def mean_knn_dist2(points, **kw):
    """distCUDA2: mean of the squared distances to the 3 nearest
    neighbours, (P,)."""
    return knn(points, K_NEAREST, **kw)[0].mean(dim=1)
