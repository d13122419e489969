"""Minimal binary-little-endian PLY codec (numpy).

A copy of reduced3dgs_tpu/data/ply.py (the port imports nothing of the JAX
package).  No `plyfile` dependency; this module implements the subset the
framework needs — multiple elements with scalar properties — with the
same on-disk layout plyfile produces, so PLYs written here are readable
by the reference tooling and vice versa (reference format:
scene/gaussian_model.py:239-311).
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


def write_ply(path, elements):
    """elements: list of (name, structured ndarray) in file order."""
    header = ["ply", "format binary_little_endian 1.0"]
    for name, arr in elements:
        header.append(f"element {name} {len(arr)}")
        for prop in arr.dtype.names:
            ply_t = _NP_TO_PLY[arr.dtype[prop].name]
            header.append(f"property {ply_t} {prop}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for _, arr in elements:
            f.write(arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())


def read_ply(path):
    """Returns an ordered dict {element_name: structured ndarray}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = f.readline().split()
        if fmt[1] != b"format" and fmt[0] != b"format":
            raise ValueError("missing format line")
        binary = b"binary_little_endian" in b" ".join(fmt)
        if not binary:
            raise ValueError("only binary_little_endian PLYs supported")
        elements = []  # (name, count, [(prop, np_type)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            parts = line.split()
            if parts[0] == b"end_header":
                break
            if parts[0] == b"comment":
                continue
            if parts[0] == b"element":
                elements.append([parts[1].decode(), int(parts[2]), []])
            elif parts[0] == b"property":
                if parts[1] == b"list":
                    raise ValueError("list properties not supported")
                elements[-1][2].append(
                    (parts[2].decode(), _PLY_TO_NP[parts[1].decode()])
                )
        out = {}
        for name, count, props in elements:
            dtype = np.dtype([(p, "<" + t) for p, t in props])
            out[name] = np.frombuffer(
                f.read(dtype.itemsize * count), dtype=dtype, count=count
            )
        return out
