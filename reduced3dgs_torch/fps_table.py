"""Rendering speed per model variant — the counterpart of
experiments/fps_table.py, on the models that
``python -m reduced3dgs_torch.compression_eval`` trained.

    python -m reduced3dgs_torch.fps_table [--root DIR] [--device cpu]

Runs the port's render CLI (``python -m reduced3dgs_torch.render
--skip_train``: the test views at one settled budget, on the card one
replayed CUDA graph of the ring, timed as measure_fps times it) for
vanilla/baseline; full/baseline, quantised, quantised_half and
quantised_pack; and full/quantised_half with --variable_sh_bands (the
ragged packed-SH path).  It prints FPS and the factor against
vanilla/baseline, appends the table to <root>/RESULTS.md and writes
<root>/fps_table.json; nothing is written outside --root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from reduced3dgs_torch import compression_eval
from reduced3dgs_torch.compression_eval import DEFAULT_ROOT, REPO

# (row tag, model directory, variants, --variable_sh_bands): one render
# CLI run per entry
RUNS = (("vanilla/", "model_vanilla", ("baseline",), False),
        ("full/", "model_full", ("baseline", "quantised", "quantised_half",
                                 "quantised_pack"), False),
        ("full/", "model_full", ("quantised_half",), True))


def run_render(model_dir, models, variable_sh=False, device="cuda"):
    """One render CLI run; returns its fps_results.json."""
    args = compression_eval.module_command("reduced3dgs_torch.render") + [
        "-m", model_dir, "--skip_train", "--quiet", "--device", str(device),
        "--models", *models]
    if variable_sh:
        args.append("--variable_sh_bands")
    r = subprocess.run(args, cwd=REPO, text=True, capture_output=True,
                       timeout=7200)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-2000:])
        raise RuntimeError(f"the render CLI failed for {model_dir}")
    with open(os.path.join(model_dir, "fps_results.json")) as f:
        return json.load(f)


def fps_rows(root, device="cuda"):
    """FPS by row tag (JAX script's tags, plus full/quantised_pack)."""
    rows = {}
    for prefix, model, variants, variable_sh in RUNS:
        fps = run_render(os.path.join(root, model), list(variants),
                         variable_sh, device)
        suffix = "+variable_sh" if variable_sh else ""
        rows.update({f"{prefix}{k}{suffix}": fps[k] for k in variants})
    order = ("vanilla/baseline", "full/baseline", "full/quantised",
             "full/quantised_half", "full/quantised_half+variable_sh",
             "full/quantised_pack")
    return {k: rows[k] for k in order}


def table(rows, device_name):
    base = rows["vanilla/baseline"]
    lines = ["", f"## Rendering speed (test views, one timed window of the "
             f"ring; {device_name})", "",
             "| model | FPS | x vs vanilla |", "|---|---|---|"]
    for tag, v in rows.items():
        lines.append(f"| {tag} | {v:.1f} | {v / base:.2f}x |")
    return lines


def device_name(device):
    import torch

    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name(0)
    return "CPU, plain versions of the kernels"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    args = ap.parse_args(argv)

    from reduced3dgs_torch.device import resolve

    device = resolve(args.device)
    t0 = time.perf_counter()
    rows = fps_rows(args.root, device)
    wall = time.perf_counter() - t0
    lines = table(rows, device_name(device))
    lines += ["", f"FPS stage: {wall:.1f} s ({len(RUNS)} render CLI runs)."]
    out = "\n".join(lines) + "\n"
    with open(os.path.join(args.root, "RESULTS.md"), "a") as f:
        f.write(out)
    with open(os.path.join(args.root, "fps_table.json"), "w") as f:
        json.dump({"fps": rows, "fps_s": wall, "device": str(device)}, f,
                  indent=1)
    print(out)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
