"""1-D k-means codebook quantisation (PyTorch).

Counterpart of reduced3dgs_tpu/ops/kmeans.py: 256-entry scalar codebooks
with uint8 ids, tolerance-based convergence, at most 500 Lloyd
iterations.  One Lloyd step is a chunked |v - c| argmin over the centres
(the lowest index wins a tie; the centres are not sorted, so this is not
a bucket search) and an ``index_add_`` centre update.  The fit stays on
the values' device; the loop reads the centre shift on the host once per
step to decide whether to stop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reduced3dgs_torch.device import resolve
from reduced3dgs_torch.models.gaussians import GaussianPool

ASSIGN_CHUNK = 1 << 16  # values per distance block of _assign
MAX_ITERATIONS = 500


class Codebook(NamedTuple):
    """ids: (...,) uint8 assignments; centers: (num_clusters, 1) values."""

    ids: torch.Tensor
    centers: torch.Tensor

    def evaluate(self):
        return self.centers[self.ids.to(torch.int64).reshape(-1)]


def codebooks_from_numpy(books: dict, device=None) -> dict:
    """{name: (ids, centers)} array pairs (the JAX package's Codebooks
    are such pairs) -> the port's Codebooks on `device`."""
    dev = resolve(device)
    out = {}
    for name, (ids, centers) in books.items():
        out[name] = Codebook(
            ids=torch.as_tensor(np.ascontiguousarray(ids), dtype=torch.uint8,
                                device=dev),
            centers=torch.as_tensor(np.ascontiguousarray(centers),
                                    dtype=torch.float32,
                                    device=dev).reshape(-1, 1))
    return out


def _assign(values, centers, chunk=ASSIGN_CHUNK):
    """Closest-centre id per value, (N,) int64."""
    out = torch.empty(values.shape[0], dtype=torch.int64,
                      device=values.device)
    for s in range(0, values.shape[0], chunk):
        blk = values[s:s + chunk]
        d = (blk[:, None] - centers[None, :]).abs()
        out[s:s + chunk] = torch.argmin(d, dim=1)
    return out


@torch.no_grad()
def kmeans_1d(values, init_centers, tol=1e-4, *, num_clusters=256,
              max_iterations=MAX_ITERATIONS, weights=None,
              return_iterations=False):
    """Lloyd iterations until sum |delta centre| < tol.  Empty clusters
    keep their previous centre.  `weights` (0/1, same flat length) keeps
    rows out of the centre updates while they still get an id.  Returns
    (ids (N,) int64, centers (num_clusters,)) and, with
    return_iterations, the number of Lloyd steps taken."""
    values = values.reshape(-1).to(torch.float32)
    fit = values
    if weights is not None:
        # zero-weight rows add nothing to any centre: the steps run on
        # the weighted rows alone, and only the last assignment sees all
        fit = values[weights.reshape(-1) > 0]
    ones = torch.ones_like(fit)
    centers = init_centers.reshape(-1).to(torch.float32)
    it = 0
    delta = float("inf")
    while delta >= tol and it < max_iterations:
        ids = _assign(fit, centers)
        sums = torch.zeros_like(centers).index_add_(0, ids, fit)
        counts = torch.zeros_like(centers).index_add_(0, ids, ones)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          centers)
        delta = float((new - centers).abs().sum())  # the one host read
        centers = new
        it += 1
    ids = _assign(values, centers)
    if return_iterations:
        return ids, centers, it
    return ids, centers


def _quantile_init(flat, weights, num_clusters):
    """Half the centres at evenly spaced quantiles of the weight > 0
    values (density), half uniformly over their [min, max] (range
    coverage, which bounds the error of sparse tails).  Deterministic;
    quantile half first, then the uniform half (not sorted)."""
    order = torch.argsort(torch.where(weights > 0, flat, torch.inf),
                          stable=True)
    n_alive = torch.clamp((weights > 0).sum(), min=1)
    nq = num_clusters // 2
    pos = (torch.arange(nq, dtype=torch.float32, device=flat.device)
           + 0.5) / nq
    idx = torch.minimum((pos * n_alive.to(torch.float32)).to(torch.int64),
                        n_alive - 1).clamp(min=0)
    qcenters = flat[order[idx]]
    vmin = flat[order[0]]
    vmax = flat[order[n_alive - 1]]
    nu = num_clusters - nq
    t = (torch.arange(nu, dtype=torch.float32, device=flat.device)
         + 0.5) / nu
    return torch.cat([qcenters, vmin + t * (vmax - vmin)])


@torch.no_grad()
def generate_codebook(values, inverse_activation_fn=lambda x: x,
                      num_clusters=256, tol=1e-4, weights=None, stats=None):
    """Quantile init, fit, and a Codebook of uint8 ids in the values'
    shape and inverse-activated centres.  stats: a list that receives the
    fit's Lloyd-step count."""
    shape = values.shape
    flat = values.reshape(-1).to(torch.float32)
    w = torch.ones_like(flat) if weights is None else weights.reshape(-1)
    ids, centers, it = kmeans_1d(
        flat, _quantile_init(flat, w, num_clusters), tol,
        num_clusters=num_clusters, weights=w, return_iterations=True)
    if stats is not None:
        stats.append(it)
    return Codebook(ids=ids.to(torch.uint8).reshape(shape),
                    centers=inverse_activation_fn(centers).reshape(-1, 1))


@torch.no_grad()
def produce_clusters(pool: GaussianPool, num_clusters=256, max_sh_degree=3,
                     stats=None):
    """The 20 codebooks of the paper — features_dc, features_rest_0..14,
    opacity (inverse-sigmoid space), scaling (log space), rotation re/im.
    Only alive rows feed the fits (dead slots get weight 0; their ids are
    computed but never saved).  Activated values that saturate in f32 are
    clamped before the inverse activation, so the centres stay finite.
    stats: a dict that receives {name: Lloyd steps}."""
    alive = pool.alive

    def wts(x):
        return alive.reshape((-1,) + (1,) * (x.ndim - 1)).expand(
            x.shape).to(torch.float32)

    def fit(name, x, **kw):
        steps = []
        book = generate_codebook(x, num_clusters=num_clusters,
                                 weights=wts(x), stats=steps, **kw)
        if stats is not None:
            stats[name] = steps[0]
        return book

    cb = {}
    cb["features_dc"] = fit("features_dc", pool.params.features_dc[:, 0],
                            tol=1e-3)
    for i in range((max_sh_degree + 1) ** 2 - 1):
        cb[f"features_rest_{i}"] = fit(f"features_rest_{i}",
                                       pool.params.features_rest[:, i])
    eps = 1e-6
    op = torch.clamp(torch.sigmoid(pool.params.opacity), eps, 1.0 - eps)
    cb["opacity"] = fit(
        "opacity", op,
        inverse_activation_fn=lambda y: torch.log(y / (1.0 - y)))
    # clamp like opacity: a diverged log-scale overflows exp in f32
    sc = torch.clamp(torch.exp(pool.params.scaling), max=1e30)
    cb["scaling"] = fit(
        "scaling", sc,
        inverse_activation_fn=lambda y: torch.log(torch.clamp(y, min=1e-30)))
    rot = pool.params.rotation
    rot = rot / torch.clamp(
        torch.sqrt((rot * rot).sum(-1, keepdim=True)), min=1e-12)
    cb["rotation_re"] = fit("rotation_re", rot[:, 0:1])
    cb["rotation_im"] = fit("rotation_im", rot[:, 1:])
    return cb


@torch.no_grad()
def apply_clustering(pool: GaussianPool, codebook_dict, max_sh_degree=3):
    """Replace the raw parameters by their dequantised codebook values."""
    max_coeffs = (max_sh_degree + 1) ** 2 - 1
    c = pool.capacity
    opacity = codebook_dict["opacity"].evaluate().reshape(c, 1)
    scaling = codebook_dict["scaling"].evaluate().reshape(c, 3)
    rotation = torch.cat(
        [codebook_dict["rotation_re"].evaluate().reshape(c, 1),
         codebook_dict["rotation_im"].evaluate().reshape(c, 3)], dim=1)
    f_dc = codebook_dict["features_dc"].evaluate().reshape(c, 1, 3)
    f_rest = torch.stack(
        [codebook_dict[f"features_rest_{i}"].evaluate().reshape(c, 3)
         for i in range(max_coeffs)], dim=1)
    return pool.replace(params=pool.params._replace(
        features_dc=f_dc, features_rest=f_rest, scaling=scaling,
        rotation=rotation, opacity=opacity))
