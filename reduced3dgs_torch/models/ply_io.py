"""Gaussian PLY interchange — the reference's multi-section format.

A numpy copy of reduced3dgs_tpu/models/ply_io.py (the port imports
nothing of the JAX package), plus ``pool_from_arrays`` returning the torch
pool.  save/load reproduce the reference layout:

  * elements `vertex_0..vertex_<max_deg>`, one per SH degree group, each
    storing only the coefficients that degree uses ("rrr ggg bbb" order),
  * optional 256-entry `codebook_centers` element (20 codebooks) with
    uint8 attribute ids (quantised) and/or int16-bitcast float16 storage
    (half_float; xyz is never codebook-quantised),
  * the "u16c" xyz codec: chunked fixed-point uint16 coordinates with an
    `xyz_chunk_bounds` element,

so files written by either package load in the other.
"""

from __future__ import annotations

import os

import numpy as np

from reduced3dgs_torch.data.ply import read_ply, write_ply

_CODEBOOK_KEYS = (
    ["features_dc"] + [f"features_rest_{i}" for i in range(15)]
    + ["opacity", "scaling", "rotation_re", "rotation_im"]
)

# xyz codec "u16c": fixed-point uint16 coordinates normalized to
# per-chunk bounding boxes (chunks of _XYZ_CHUNK Morton-ordered rows
# per degree group, bounds in an extra `xyz_chunk_bounds` element).
# Same 6 bytes/primitive as the reference's float16 xyz but ~16-100x
# finer resolution: float16's 2^-11 relative precision at scene-extent
# magnitudes dominates the reference half format's PSNR cost (measured:
# the ENTIRE -0.8 dB quantised->quantised_half step on the synthetic
# eval is xyz f16 rounding; u16c is lossless to 1e-3 dB).  This is a
# framework extension — the reference loader (gaussian_model.py:318-396)
# reads only the f16 layout.
_XYZ_CHUNK = 256
MAX_SH_DEGREE = 3  # the format's top degree: a loaded pool's active one


def _morton_order(p, bits=16):
    """Indices sorting rows of (N,3) float positions by Morton code."""
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-12)
    g = ((p - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(p), np.uint64)
    for b in range(bits):
        for a in range(3):
            code |= ((g[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                3 * b + a)
    return np.argsort(code, kind="stable")


def _encode_xyz_u16c(x):
    """(N,3) f32 -> (u16 codes, (nchunks, 6) f32 lo/hi bounds)."""
    n = x.shape[0]
    nchunks = -(-n // _XYZ_CHUNK) if n else 0
    codes = np.zeros((n, 3), np.uint16)
    bounds = np.zeros((nchunks, 6), np.float32)
    for c in range(nchunks):
        rows = slice(c * _XYZ_CHUNK, min((c + 1) * _XYZ_CHUNK, n))
        lo = x[rows].min(axis=0)
        hi = x[rows].max(axis=0)
        scale = np.maximum(hi - lo, 1e-12) / 65535.0
        codes[rows] = np.round((x[rows] - lo) / scale).clip(0, 65535)
        bounds[c, :3] = lo
        bounds[c, 3:] = hi
    return codes, bounds


def _decode_xyz_u16c(codes, bounds):
    n = codes.shape[0]
    x = np.zeros((n, 3), np.float32)
    for c in range(bounds.shape[0]):
        rows = slice(c * _XYZ_CHUNK, min((c + 1) * _XYZ_CHUNK, n))
        lo, hi = bounds[c, :3], bounds[c, 3:]
        scale = np.maximum(hi - lo, 1e-12) / 65535.0
        x[rows] = codes[rows].astype(np.float32) * scale + lo
    return x


def _attr_names(rest_coeffs):
    return (
        ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(rest_coeffs)]
        + ["opacity", "scale_0", "scale_1", "scale_2",
           "rot_0", "rot_1", "rot_2", "rot_3"]
    )


def _np(x):
    """numpy view of an array or a (possibly CUDA) torch tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_half_bits(a):
    return a.astype(np.float16).view(np.int16)


def save_gaussian_ply(path, pool, codebook_dict=None, quantised=False,
                      half_float=False, max_sh_degree=3, xyz_codec=None):
    """Write the pool's alive primitives grouped by SH degree.

    xyz_codec: "f32" | "f16" | "u16c" (default: "f16" when half_float
    else "f32").  "u16c" = chunked fixed-point uint16 (see _XYZ_CHUNK
    note above); rows within each degree group are Morton-reordered to
    tighten the chunk boxes (row order inside a group carries no
    meaning in the format).
    """
    if xyz_codec is None:
        xyz_codec = "f16" if half_float else "f32"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    float_type = "i2" if half_float else "f4"
    xyz_type = {"f32": "f4", "f16": "i2", "u16c": "u2"}[xyz_codec]
    attr_type = "u1" if quantised else float_type

    alive = _np(pool.alive)
    degrees = _np(pool.degrees)
    xyz = _np(pool.params.xyz)
    if quantised:
        if codebook_dict is None:
            raise ValueError("quantised save requires a codebook_dict")
        f_dc = _np(codebook_dict["features_dc"].ids).reshape(-1, 3)
        f_rest = np.stack(
            [_np(codebook_dict[f"features_rest_{i}"].ids)
             for i in range(15)], axis=1,
        ).reshape(-1, 15, 3)
        opacity = _np(codebook_dict["opacity"].ids).reshape(-1, 1)
        scaling = _np(codebook_dict["scaling"].ids).reshape(-1, 3)
        rot = np.concatenate(
            [_np(codebook_dict["rotation_re"].ids).reshape(-1, 1),
             _np(codebook_dict["rotation_im"].ids).reshape(-1, 3)],
            axis=1,
        )
    else:
        f_dc = _np(pool.params.features_dc).reshape(-1, 3)
        f_rest = _np(pool.params.features_rest)
        opacity = _np(pool.params.opacity)
        scaling = _np(pool.params.scaling)
        rot = _np(pool.params.rotation)

    elements = []
    all_bounds = []
    for deg in range(max_sh_degree + 1):
        coeffs = (deg + 1) ** 2 - 1
        idx = np.nonzero(alive & (degrees == deg))[0]
        n = len(idx)
        if xyz_codec == "u16c" and n:
            idx = idx[_morton_order(xyz[idx])]
        if xyz_codec == "u16c":
            x, bounds = _encode_xyz_u16c(xyz[idx].astype(np.float32))
            all_bounds.append(bounds)
        elif xyz_codec == "f16":
            x = _to_half_bits(xyz[idx])
        else:
            x = xyz[idx].astype(np.float32)
        # "rrr ggg bbb": (n, coeffs, 3) -> (n, 3, coeffs) -> flat
        fr = (f_rest[idx][:, :coeffs].transpose(0, 2, 1)
              .reshape(n, coeffs * 3))
        def flat2d(c):  # n == 0 safe (np refuses reshape((0, -1)))
            return c.reshape(n, int(np.prod(c.shape[1:], dtype=np.int64)))

        attrs = np.concatenate(
            [flat2d(c) for c in
             (f_dc[idx], fr, opacity[idx], scaling[idx], rot[idx])], axis=1)
        if quantised:
            attrs = attrs.astype(np.uint8)
        elif half_float:
            attrs = _to_half_bits(attrs.astype(np.float32))
        else:
            attrs = attrs.astype(np.float32)
        names = _attr_names(coeffs * 3)
        dtype = np.dtype([
            (a, xyz_type if a in ("x", "y", "z") else attr_type)
            for a in names
        ])
        rec = np.empty(n, dtype=dtype)
        for j, a in enumerate(names[:3]):
            rec[a] = x[:, j]
        for j, a in enumerate(names[3:]):
            rec[a] = attrs[:, j]
        elements.append((f"vertex_{deg}", rec))
    if xyz_codec == "u16c":
        bnd = (np.concatenate(all_bounds, axis=0) if all_bounds
               else np.zeros((0, 6), np.float32))
        names = ["lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z"]
        rec = np.empty(bnd.shape[0],
                       dtype=np.dtype([(a, "f4") for a in names]))
        for j, a in enumerate(names):
            rec[a] = bnd[:, j]
        elements.append(("xyz_chunk_bounds", rec))

    if quantised:
        centers = [_np(codebook_dict[k].centers).reshape(-1, 1)
                   for k in _CODEBOOK_KEYS]
        cat = np.concatenate(centers, axis=1).astype(np.float32)
        if half_float:
            cat = _to_half_bits(cat)
        rec = np.empty(cat.shape[0],
                       dtype=np.dtype([(k, float_type)
                                       for k in _CODEBOOK_KEYS]))
        for j, k in enumerate(_CODEBOOK_KEYS):
            rec[k] = cat[:, j]
        elements.append(("codebook_centers", rec))
    write_ply(path, elements)


def _from_half_bits(a):
    return np.asarray(a).view(np.float16).astype(np.float32)


def load_gaussian_ply(path, quantised=False, half_float=False,
                      max_sh_degree=3, xyz_codec=None):
    """Read a (possibly quantised / half-float) multi-section PLY.

    Returns dict of dense numpy arrays: xyz, features_dc (N,1,3),
    features_rest (N,15,3), opacity (N,1), scaling, rotation, degrees.
    xyz_codec: as in save_gaussian_ply; "u16c" autodetected from the
    presence of the xyz_chunk_bounds element when not given.
    """
    data = read_ply(path)
    if xyz_codec is None:
        if "xyz_chunk_bounds" in data:
            xyz_codec = "u16c"
        else:
            xyz_codec = "f16" if half_float else "f32"
    max_coeffs = (max_sh_degree + 1) ** 2 - 1
    if xyz_codec == "u16c":
        cb = data["xyz_chunk_bounds"]
        chunk_bounds = np.stack(
            [np.asarray(cb[a]) for a in
             ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z")],
            axis=1).astype(np.float32)
        bounds_used = 0

    centers = None
    if quantised:
        cb = data["codebook_centers"]

        def c(k):
            v = np.asarray(cb[k])
            return _from_half_bits(v) if half_float else v.astype(np.float32)

        centers = {k: c(k) for k in _CODEBOOK_KEYS}
        centers["features_rest"] = np.stack(
            [centers[f"features_rest_{i}"] for i in range(max_coeffs)],
            axis=1,
        )  # (256, 15)

    outs = {k: [] for k in ("xyz", "features_dc", "features_rest", "opacity",
                            "scaling", "rotation", "degrees")}
    for deg in range(max_sh_degree + 1):
        v = data[f"vertex_{deg}"]
        n = len(v)
        coeffs = (deg + 1) ** 2 - 1

        def vec(prefix, count):
            return np.stack([np.asarray(v[f"{prefix}_{i}"])
                             for i in range(count)], axis=1)

        xyz = np.stack([np.asarray(v["x"]), np.asarray(v["y"]),
                        np.asarray(v["z"])], axis=1)
        if xyz_codec == "u16c":
            nchunks = -(-n // _XYZ_CHUNK) if n else 0
            xyz = _decode_xyz_u16c(
                xyz.astype(np.uint16),
                chunk_bounds[bounds_used:bounds_used + nchunks])
            bounds_used += nchunks
        elif xyz_codec == "f16":
            xyz = _from_half_bits(xyz)
        else:
            xyz = xyz.astype(np.float32)
        f_dc = vec("f_dc", 3).reshape(n, 1, 3)
        # stored rrr ggg bbb -> (n, 3, coeffs) -> (n, coeffs, 3)
        if coeffs:
            f_rest = vec("f_rest", coeffs * 3).reshape(n, 3, coeffs)
            f_rest = f_rest.transpose(0, 2, 1)
        else:
            f_rest = np.zeros((n, 0, 3), dtype=f_dc.dtype)
        opacity = np.asarray(v["opacity"]).reshape(n, 1)
        scaling = vec("scale", 3)
        rot = vec("rot", 4)

        if quantised:
            f_dc = centers["features_dc"][f_dc.astype(np.int64)]
            if coeffs:
                f_rest = np.stack(
                    [centers[f"features_rest_{i}"][
                        f_rest[:, i].astype(np.int64)]
                     for i in range(coeffs)], axis=1,
                )
            else:
                f_rest = np.zeros((n, 0, 3), np.float32)
            opacity = centers["opacity"][opacity.astype(np.int64)].reshape(n, 1)
            scaling = centers["scaling"][scaling.astype(np.int64)]
            rot = np.concatenate(
                [centers["rotation_re"][rot[:, :1].astype(np.int64)],
                 centers["rotation_im"][rot[:, 1:].astype(np.int64)]], axis=1)
        elif half_float:
            f_dc = _from_half_bits(f_dc)
            f_rest = _from_half_bits(f_rest)
            opacity = _from_half_bits(opacity)
            scaling = _from_half_bits(scaling)
            rot = _from_half_bits(rot)

        pad = np.zeros((n, max_coeffs - coeffs, 3), np.float32)
        outs["xyz"].append(xyz)
        outs["features_dc"].append(f_dc.astype(np.float32))
        outs["features_rest"].append(
            np.concatenate([f_rest.astype(np.float32), pad], axis=1))
        outs["opacity"].append(opacity.astype(np.float32))
        outs["scaling"].append(scaling.astype(np.float32))
        outs["rotation"].append(rot.astype(np.float32))
        outs["degrees"].append(np.full(n, deg, np.int32))

    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def pool_from_arrays(arrs, device=None, capacity=None):
    """Build the torch GaussianPool from load_gaussian_ply output, padded
    to the same power-of-two capacity the JAX pool uses, at the top SH
    degree as the JAX package loads it: a stored model has finished its
    degree steps, so training it on (compress.py's fine-tune) never raises
    the primitives' own degrees again."""
    from reduced3dgs_torch.models.gaussians import (
        padded_leaves, pool_from_numpy,
    )

    leaves = padded_leaves(arrs, capacity)
    leaves["active_sh_degree"] = MAX_SH_DEGREE
    return pool_from_numpy(leaves, device)
