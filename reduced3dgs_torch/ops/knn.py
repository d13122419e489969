"""Mean squared distance to the 3 nearest neighbours (PyTorch).

Counterpart of ``mean_knn_dist2`` in reduced3dgs_tpu/ops/knn.py (the
reference's distCUDA2, used to initialise scales) in its exact semantics,
``knn(..., exact=True)``: a blocked brute-force search in plain PyTorch.
Candidates are selected on the expanded form |q|^2 - 2 q.c + |c|^2 (a
matrix product per block of queries), excluding the query itself, and
the selected neighbours' squared distances are then recomputed by direct
subtraction, exactly as the JAX package does.  Rows with non-finite
coordinates are "absent" (the JAX package's convention for the padding of
a compacted pool): an absent row is never a neighbour while a real other
point is left, and its own neighbours mean nothing.  O(P^2) work; the
JAX package's Morton window and certified blocked search, which give the
same neighbours faster, are not ported.
"""

from __future__ import annotations

import torch

K_NEAREST = 3
# query rows x candidates per distance block, by device type
_PAIRS_PER_BLOCK = {"cpu": 1 << 24, "cuda": 1 << 27}


def _knn_real(points, k: int):
    """knn_exact on finite points."""
    p = points.shape[0]
    q_rows = max(1, _PAIRS_PER_BLOCK.get(points.device.type, 1 << 24)
                 // max(p, 1))
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


def knn_exact(points, k: int):
    """(P, k) squared distances and int64 indices of the k nearest other
    points (ascending).  Where fewer than k real other points exist the
    rest of the row has distance inf (and lists an absent row if there is
    one); an absent row's own lists are all inf."""
    finite = torch.isfinite(points).all(dim=-1)
    if bool(finite.all()):
        return _knn_real(points, k)
    # search the real rows only: inf - inf never forms, and no work is
    # spent on the padding
    p = points.shape[0]
    real = torch.nonzero(finite).flatten()
    gone = torch.nonzero(~finite).flatten()[0]
    d_r, i_r = _knn_real(points[real], k)
    dist = points.new_full((p, k), torch.inf)
    idx = gone.expand(p, k).clone()
    dist[real] = d_r
    idx[real] = torch.where(torch.isfinite(d_r), real[i_r], gone)
    return dist, idx


def mean_knn_dist2(points):
    """distCUDA2: mean of the squared distances to the 3 nearest
    neighbours, (P,)."""
    return knn_exact(points, K_NEAREST)[0].mean(dim=1)
