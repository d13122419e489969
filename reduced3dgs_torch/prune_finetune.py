"""The offline prune -> fine-tune -> quantise ladder — the counterpart of
experiments/prune_finetune.py, on the models that
``python -m reduced3dgs_torch.compression_eval`` trained.

    python -m reduced3dgs_torch.prune_finetune [--root DIR] \\
        [--model model_full] [--fracs 0.10 0.14 0.18] [--ft_iters 1000] \\
        [--iterations N] [--device cpu]

Loads the stored full-precision model <root>/<model> at iteration N (the
JAX script's 10,000 by default) and scores its test views.  For each
fraction it prunes that share of the lowest-opacity alive primitives and
fine-tunes the rest for --ft_iters plain iterations (no densify, mercy
or opacity reset; the xyz learning rate at its final value; bf16x2
gradients; groups of up to 16 fusible iterations through
Trainer.step_group, a replayed CUDA graph on the card), both through the
offline compression CLI's code (compress.py: prune_pool, finetune).  It
then fits the codebooks, saves the quantised + half-float PLY with the
chunked uint16 xyz codec to <root>/prune_finetune/pf_<F>.ply, reloads
that file and scores it.  Per fraction it records the JAX script's keys
(n, ft_psnr, pack_psnr, bytes) and, where <root>/model_vanilla holds the
vanilla PLY of the same iteration, the size factor against it.  The JSON
goes to <root>/prune_finetune.json.  On the card unless --device cpu is
given.

The JAX script fuses every fusible iteration of a 16-iteration window
even past a non-fusible one, and then never runs the one it skipped (the
% 1000 SH-degree iteration); here a group ends before it and step() runs
it, as the training CLI and compress.py do.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from reduced3dgs_torch.compression_eval import (
    DEFAULT_ROOT, ITER, mean_psnr, ply_path, stored_model,
)

DEFAULT_FRACS = (0.10, 0.14, 0.18)


def store_pack(pool, path):
    """Fit the codebooks, write the quantised + half-float PLY with the
    u16c xyz codec to `path` and load it back; returns (the reloaded
    pool, the fit's seconds)."""
    from reduced3dgs_torch.models.ply_io import (
        load_gaussian_ply, pool_from_arrays, save_gaussian_ply,
    )
    from reduced3dgs_torch.ops.kmeans import produce_clusters

    t0 = time.perf_counter()
    codebooks = produce_clusters(pool)
    fit_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_gaussian_ply(path, pool, codebooks, quantised=True,
                      half_float=True, xyz_codec="u16c")
    return pool_from_arrays(load_gaussian_ply(
        path, quantised=True, half_float=True), pool.device), fit_s


def rung(pool0, scene, frac, ft_iters, start, path):
    """One rung of the ladder: prune `frac` of pool0's alive rows,
    fine-tune `ft_iters` iterations after `start` (compress.py's
    finetune), store the pack file at `path`, reload and score it.
    Returns the rung's record."""
    from reduced3dgs_torch.compress import finetune, prune_pool

    stats = {}
    pool = finetune(prune_pool(pool0, frac)[0], scene, start, ft_iters,
                    stats)
    test_cams = scene.get_test_cameras()
    rpool, fit_s = store_pack(pool, path)
    return {"n": int(pool.alive.sum()),
            "ft_psnr": mean_psnr(pool, test_cams, pool.device),
            "pack_psnr": mean_psnr(rpool, test_cams, pool.device),
            "bytes": os.path.getsize(path),
            "finetune_s": stats["finetune_s"], "fit_s": fit_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--model", default="model_full")
    ap.add_argument("--fracs", nargs="+", type=float,
                    default=list(DEFAULT_FRACS))
    ap.add_argument("--ft_iters", type=int, default=1000)
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
    log_launches_at_exit("prune_finetune")
    it = args.iterations
    scene, pool0 = stored_model(args.root, args.model, it, device)
    n0 = int(pool0.alive.sum())
    base_psnr = mean_psnr(pool0, scene.get_test_cameras(), device)
    print(f"start: {n0} primitives, test PSNR {base_psnr:.3f}", flush=True)
    vanilla = ply_path(os.path.join(args.root, "model_vanilla"), it,
                       "baseline")
    vanilla_bytes = (os.path.getsize(vanilla) if os.path.exists(vanilla)
                     else None)

    results = {"base": {"psnr": base_psnr, "n": n0}}
    for frac in args.fracs:
        path = os.path.join(args.root, "prune_finetune",
                            f"pf_{int(frac * 100)}.ply")
        r = rung(pool0, scene, frac, args.ft_iters, it, path)
        if vanilla_bytes:
            r["x_vs_vanilla"] = vanilla_bytes / r["bytes"]
        results[f"frac_{frac}"] = r
        print(f"frac {frac:.2f}: n={r['n']} ft_psnr={r['ft_psnr']:.3f} "
              f"pack_psnr={r['pack_psnr']:.3f} size={r['bytes'] / 1e6:.3f} "
              f"MB x_vs_vanilla={r.get('x_vs_vanilla', float('nan')):.1f} "
              f"(fine-tune {r['finetune_s']:.1f} s, codebooks "
              f"{r['fit_s']:.1f} s)", flush=True)
    results["device"] = str(device)
    print(json.dumps(results))
    with open(os.path.join(args.root, "prune_finetune.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
