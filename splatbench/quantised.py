"""The reduced-3DGS `quantised_half` model: seeded 256-entry codebooks and
uint8 indices over a scene's primitives, and a writer of the stored file.

Frozen with the benchmark (written for it at commit d31b96e, from the
published format of Papantonakis et al. 2024, `scene/gaussian_model.py`
save_ply of graphdeco-inria/reduced-3dgs): a binary little-endian PLY
with one element `vertex_<d>` per SH degree d (each storing only the
coefficients its degree uses, "rrr ggg bbb"), float16 positions stored
as int16 bits, uint8 codebook indices for every other attribute, and a
256-row element `codebook_centers` of float16 centres (20 codebooks:
features_dc, features_rest_0..14, opacity, scaling, rotation_re,
rotation_im).
"""

from __future__ import annotations

import numpy as np
import torch

CODEBOOKS = (["features_dc"] + [f"features_rest_{i}" for i in range(15)]
             + ["opacity", "scaling", "rotation_re", "rotation_im"])
ENTRIES = 256


def _centres(values):
    """256 float16 centres at evenly spaced quantiles of `values`."""
    v = torch.sort(values.reshape(-1).float()).values
    idx = torch.linspace(0, v.numel() - 1, ENTRIES,
                         device=v.device).round().long()
    return v[idx].half()


def _indices(values, centres):
    """The nearest centre of each value (uint8)."""
    c = centres.float()
    mids = 0.5 * (c[1:] + c[:-1])
    return torch.bucketize(values.float().contiguous(), mids).to(torch.uint8)


def quantise(leaves, n: int):
    """(codebooks {name: (256,) float16}, indices {name: uint8 tensor},
    xyz float16) of the first n rows of `leaves` (scene.primitives).
    features_rest_i is fitted to the primitives whose degree keeps
    coefficient i."""
    deg = leaves["degrees"][:n]
    cols = {
        "features_dc": leaves["features_dc"][:n, 0],
        "opacity": leaves["opacity"][:n],
        "scaling": leaves["scaling"][:n],
        "rotation_re": leaves["rotation"][:n, :1],
        "rotation_im": leaves["rotation"][:n, 1:],
    }
    for i in range(15):
        cols[f"features_rest_{i}"] = leaves["features_rest"][:n, i]
    books, ids = {}, {}
    for name in CODEBOOKS:
        vals = cols[name]
        fit = vals
        if name.startswith("features_rest_"):
            i = int(name.rsplit("_", 1)[1])
            keep = deg >= int(np.floor(np.sqrt(i + 1)))
            fit = vals[keep] if bool(keep.any()) else vals
        books[name] = _centres(fit)
        ids[name] = _indices(vals, books[name])
    return books, ids, leaves["xyz"][:n].half()


def write(path, books, ids, xyz_half, degrees):
    """The `quantised_half` PLY of the quantised rows (host copies are
    made here), grouped by degree in row order."""
    deg = degrees.cpu().numpy()
    xyz = xyz_half.cpu().numpy().view(np.int16)
    host = {k: v.cpu().numpy() for k, v in ids.items()}
    elements = []
    for d in range(4):
        rows = np.nonzero(deg == d)[0]
        coeffs = (d + 1) ** 2 - 1
        names = (["x", "y", "z"] + [f"f_dc_{j}" for j in range(3)]
                 + [f"f_rest_{j}" for j in range(3 * coeffs)]
                 + ["opacity"] + [f"scale_{j}" for j in range(3)]
                 + [f"rot_{j}" for j in range(4)])
        rec = np.empty(len(rows), dtype=np.dtype(
            [(a, "<i2" if a in ("x", "y", "z") else "u1") for a in names]))
        for j, a in enumerate("xyz"):
            rec[a] = xyz[rows, j]
        for j in range(3):
            rec[f"f_dc_{j}"] = host["features_dc"][rows, j]
        for i in range(coeffs):  # stored channel-major: rrr ggg bbb
            for c in range(3):
                rec[f"f_rest_{c * coeffs + i}"] = \
                    host[f"features_rest_{i}"][rows, c]
        rec["opacity"] = host["opacity"][rows, 0]
        for j in range(3):
            rec[f"scale_{j}"] = host["scaling"][rows, j]
        rec["rot_0"] = host["rotation_re"][rows, 0]
        for j in range(3):
            rec[f"rot_{j + 1}"] = host["rotation_im"][rows, j]
        elements.append((f"vertex_{d}", rec))
    cb = np.empty(ENTRIES, dtype=np.dtype([(k, "<i2") for k in CODEBOOKS]))
    for k in CODEBOOKS:
        cb[k] = books[k].cpu().numpy().view(np.int16)
    elements.append(("codebook_centers", cb))
    types = {"<i2": "short", "u1": "uchar", "|u1": "uchar"}
    header = ["ply", "format binary_little_endian 1.0"]
    for name, arr in elements:
        header.append(f"element {name} {len(arr)}")
        for prop in arr.dtype.names:
            header.append(f"property {types[arr.dtype[prop].str]} {prop}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for _, arr in elements:
            f.write(arr.tobytes())
