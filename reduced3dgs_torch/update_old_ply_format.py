"""Old-format PLY migrator of the port: the counterpart of root
update_old_ply_format.py, on the port's data/ply.py.

    python -m reduced3dgs_torch.update_old_ply_format -m <in.ply> \\
        [-o <out.ply>]

Converts a vanilla-3DGS single-element PLY (one `vertex` element with
unused normals) into the reduced-3DGS multi-section `vertex_0..3` layout
with every primitive in the top SH band, so old models load in the port
and its viewers.  Without -o the input file is rewritten.
"""

from __future__ import annotations

import math
from argparse import ArgumentParser

import numpy as np

from reduced3dgs_torch.data.ply import read_ply, write_ply


def infer_max_sh_order(num_props):
    """From the property count (update_old_ply_format.py:23-28):
    59 floats => order 3, 38 => 2, 23 => 1, 14 => 0."""
    n_rest = (num_props - 14) // 3
    return int(math.sqrt(n_rest + 1)) - 1


def convert_ply(in_path, out_path=None):
    data = read_ply(in_path)
    if "vertex" not in data:
        raise ValueError(f"{in_path}: not an old-format PLY (no 'vertex')")
    v = data["vertex"]
    names = [n for n in v.dtype.names if not n.startswith("n")]  # no normals
    order = infer_max_sh_order(len(names))
    if order != 3:
        raise ValueError(f"unsupported SH order {order} (expected 3)")

    elements = []
    for deg in range(4):
        coeffs = (deg + 1) ** 2 - 1
        attrs = [n for n in names
                 if not n.startswith("f_rest_")
                 or int(n.split("_")[-1]) < coeffs * 3]
        out = np.empty(len(v) if deg == 3 else 0,
                       dtype=np.dtype([(n, "f4") for n in attrs]))
        if deg == 3:
            for n in attrs:
                out[n] = v[n]
        elements.append((f"vertex_{deg}", out))
    out_path = out_path or in_path
    write_ply(out_path, elements)
    print(f"Converted {in_path} -> {out_path} ({len(v)} primitives)")


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--output_path", "-o", default=None)
    args = parser.parse_args(argv)
    convert_ply(args.model_path, args.output_path)


if __name__ == "__main__":
    main()
