"""Results aggregator of the port: the counterpart of root
generate_results.py, on the port's data/ply.py and without pandas.

    python -m reduced3dgs_torch.generate_results -m <model_dir> ... \\
        [--iteration N]

Per model directory and stored variant: the analytic memory model
(float / byte / half widths per attribute and the codebook overhead,
generate_results.py:43-111 of the reference, against the 59-float
uncompressed baseline), the share of primitives per SH band, and the
metrics of results.json and fps_results.json.  Prints the table and
writes summary.csv beside the first model directory.
"""

from __future__ import annotations

import csv
import json
import os
from argparse import ArgumentParser

from reduced3dgs_torch.data.ply import read_ply

BASELINE_FLOATS = 59  # xyz 3 + dc 3 + rest 45 + opacity 1 + scale 3 + rot 4
VARIANT_FILES = (
    ("baseline", "point_cloud.ply"),
    ("quantised", "point_cloud_quantised.ply"),
    ("quantised_half", "point_cloud_quantised_half.ply"),
    ("quantised_pack", "point_cloud_quantised_pack.ply"),
)


def memory_results(model_dir, iteration):
    """{variant: row} for each stored variant of the iteration."""
    base = os.path.join(model_dir, "point_cloud", f"iteration_{iteration}")
    rows = {}
    for variant, fname in VARIANT_FILES:
        path = os.path.join(base, fname)
        if not os.path.exists(path):
            continue
        data = read_ply(path)
        counts = {name: len(el) for name, el in data.items()
                  if name.startswith("vertex_")}
        total = sum(counts.values())
        half_like = "half" in variant or "pack" in variant
        analytic = 0  # bytes per band: xyz + the other attributes
        for name, n in counts.items():
            deg = int(name.split("_")[1])
            coeffs = (deg + 1) ** 2 - 1
            attr = 3 + coeffs * 3 + 1 + 3 + 4  # dc + rest + op + scale + rot
            xyz_b = 2 if half_like else 4  # pack: u16 fixed point
            attr_b = 1 if "quantised" in variant else xyz_b
            analytic += n * (3 * xyz_b + attr * attr_b)
        if "codebook_centers" in data:
            analytic += 256 * 20 * (2 if half_like else 4)
        if "xyz_chunk_bounds" in data:
            analytic += len(data["xyz_chunk_bounds"]) * 24
        size = os.path.getsize(path)
        rows[variant] = {
            "n_points": total,
            **{f"pct_band_{k.split('_')[1]}": 100.0 * v / max(total, 1)
               for k, v in counts.items()},
            "disk_MB": size / 1e6,
            "analytic_MB": analytic / 1e6,
            "uncompressed_MB": total * BASELINE_FLOATS * 4 / 1e6,
            "compression_x": total * BASELINE_FLOATS * 4 / max(size, 1),
        }
    return rows


def _load_json(path):
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def records(model_paths, iteration):
    """One dict per (model, stored variant): the memory row, the test
    metrics of every results.json key that names the variant (later keys
    win, as in the reference), and the variant's FPS."""
    out = []
    for model in model_paths:
        results = _load_json(os.path.join(model, "results.json"))
        fps = _load_json(os.path.join(model, "fps_results.json"))
        for variant, row in memory_results(model, iteration).items():
            rec = {"model": os.path.basename(model.rstrip("/")),
                   "variant": variant, **row}
            for key, metrics in results.items():
                if variant in key and key.startswith("test"):
                    rec.update(metrics)
            if variant in fps:
                rec["fps"] = fps[variant]
            out.append(rec)
    return out


def columns(recs):
    """Every key of the records, in order of first appearance."""
    cols = {}
    for r in recs:
        cols.update(dict.fromkeys(r))
    return list(cols)


def _text(v):
    if v is None:
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def table(recs) -> str:
    """The records as a right-aligned text table, a row per record."""
    cols = columns(recs)
    cells = [cols] + [[_text(r.get(c)) for c in cols] for r in recs]
    widths = [max(len(row[i]) for row in cells) for i in range(len(cols))]
    return "\n".join(" ".join(cell.rjust(w) for cell, w in zip(row, widths))
                     for row in cells)


def write_csv(path, recs):
    cols = columns(recs)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for r in recs:
            w.writerow([_text(r.get(c)) for c in cols])


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--iteration", type=int, default=30000)
    args = parser.parse_args(argv)
    recs = records(args.model_paths, args.iteration)
    print(table(recs))
    out = os.path.join(os.path.dirname(args.model_paths[0]), "summary.csv")
    write_csv(out, recs)
    print(f"\nWritten {out}")
    return recs


if __name__ == "__main__":
    main()
