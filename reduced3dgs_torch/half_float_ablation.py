"""Where the half-float PSNR cost concentrates — the counterpart of
experiments/half_float_ablation.py, on the models that
``python -m reduced3dgs_torch.compression_eval`` trained.

    python -m reduced3dgs_torch.half_float_ablation [--root DIR] \\
        [--model model_full] [--iterations N] [--device cpu]

Loads the stored full-precision model <root>/<model> at iteration N (the
JAX script's 10,000 by default) through Scene.load_model(quantised=False,
half_float=False) and scores the test views' mean PSNR (black background,
the tile renderer at a 2^21-instance budget, images clamped to [0, 1])
for f32_all, then for each of the six attribute groups rounded alone
through float16 (f16_<group>), then for f16_all.  It prints the JAX
script's rows and writes its JSON ({"psnr": rows, "ranges": each group's
min / max / absmax over the pool's capacity rows}, with the device and
the seconds) to <root>/half_float_ablation.json.  On the card unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from reduced3dgs_torch.compression_eval import (
    DEFAULT_ROOT, ITER, mean_psnr, stored_model,
)

GROUPS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")


def f16(x):
    """`x` rounded through float16 and back to float32."""
    import torch

    return x.to(torch.float32).to(torch.float16).to(torch.float32)


def ablation_rows(pool, cams, device):
    """f32_all, f16_<group> for each group alone, f16_all: the mean PSNR
    of `pool` over `cams` with those groups rounded through float16
    (mean_psnr).  Prints each row as the JAX script does."""
    base = {g: getattr(pool.params, g) for g in GROUPS}

    def score(arrs):
        return mean_psnr(pool.replace(params=pool.params._replace(**arrs)),
                         cams, device)

    rows = {"f32_all": score(base)}
    print(f"f32_all           {rows['f32_all']:.3f}", flush=True)
    for g in GROUPS:
        rows[f"f16_{g}"] = score(dict(base, **{g: f16(base[g])}))
        print(f"f16_{g:<14}{rows[f'f16_{g}']:.3f}  (delta "
              f"{rows[f'f16_{g}'] - rows['f32_all']:+.3f})", flush=True)
    rows["f16_all"] = score({g: f16(v) for g, v in base.items()})
    print(f"f16_all           {rows['f16_all']:.3f}  (delta "
          f"{rows['f16_all'] - rows['f32_all']:+.3f})", flush=True)
    return rows


def ranges(pool):
    """Each group's min, max and absmax over the pool's capacity rows."""
    out = {}
    for g in GROUPS:
        v = getattr(pool.params, g).detach().cpu().numpy()
        out[g] = {"min": float(np.min(v)), "max": float(np.max(v)),
                  "absmax": float(np.abs(v).max())}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--model", default="model_full")
    ap.add_argument("--iterations", type=int, default=ITER,
                    help="the stored model's iteration (compression_eval's "
                         "--iterations)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    args = ap.parse_args(argv)

    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import log_launches_at_exit

    device = resolve(args.device)
    log_launches_at_exit("half_float_ablation")
    t0 = time.perf_counter()
    scene, pool = stored_model(args.root, args.model, args.iterations,
                               device)
    rows = ablation_rows(pool, scene.get_test_cameras(), device)
    record = {"psnr": rows, "ranges": ranges(pool), "device": str(device),
              "seconds": time.perf_counter() - t0}
    print(json.dumps(record, indent=1))
    with open(os.path.join(args.root, "half_float_ablation.json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
