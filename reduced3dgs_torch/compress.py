"""Offline compression CLI of the port — counterpart of the root compress.py.

    python -m reduced3dgs_torch.compress -m <model_dir> [--iteration N] \\
        [--pack_xyz] [--prune_frac F [--finetune_iters N]] [--seed S] \\
        [--device cpu]

Loads point_cloud/iteration_N/point_cloud.ply of a trained model
directory (the latest iteration by default; the source path and options
come from its cfg_args), fits the 20 k-means codebooks (ops/kmeans.py)
and writes point_cloud_quantised.ply and point_cloud_quantised_half.ply
beside it without retraining, and with --pack_xyz also
point_cloud_quantised_pack.ply (chunked fixed-point uint16 xyz).

--prune_frac F first drops the F lowest-opacity fraction of the alive
primitives; with --finetune_iters N the pruned model then trains N plain
iterations on the scene's training views (densification off, the xyz
learning rate at its final value), in groups of up to 16 fusible
iterations through Trainer.step_group (a replayed CUDA graph of the step
on the card), so that the remaining primitives take over the pruned ones'
share.  --seed is accepted as by the root compress.py, whose codebook fit
ignores its key; the port's fit is deterministic.  On the card unless
--device cpu is given.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import numpy as np

FINETUNE_GROUP = 16  # fusible iterations per step_group


def prune_lowest_opacity(alive, opacity_logits, frac):
    """The alive mask without the `frac` lowest-opacity fraction of the
    alive rows (numpy; the root compress.py's selection).  Returns (mask,
    number pruned)."""
    op = 1.0 / (1.0 + np.exp(-opacity_logits))
    k = int(alive.sum() * frac)
    cut = np.argsort(np.where(alive, op, np.inf))[:k]
    mask = alive.copy()
    mask[cut] = False
    return mask, k


def prune_pool(pool, frac):
    """`pool` without the `frac` lowest-opacity fraction of its alive rows
    (prune_lowest_opacity); returns (pool, number pruned)."""
    import torch

    mask, k = prune_lowest_opacity(pool.alive.cpu().numpy(),
                                   pool.params.opacity[:, 0].cpu().numpy(),
                                   frac)
    return pool.replace(alive=torch.as_tensor(mask, device=pool.device)), k


def finetune(pool, scene, start, iters, stats=None):
    """`iters` plain training iterations after `start` on the scene's
    training cameras; returns the trained pool.  stats: a dict that
    receives the seconds ("finetune_s", synchronized by reading the last
    loss), the last loss ("loss") and the Trainer ("trainer")."""
    from reduced3dgs_torch.config import OptimizationParams
    from reduced3dgs_torch.train.trainer import Trainer

    cfg = OptimizationParams(
        iterations=start + iters, position_lr_max_steps=start,
        densify_from_iter=0, densify_until_iter=0,
        opacity_reset_interval=10 ** 9)
    tr = Trainer(pool, cfg, scene.get_train_cameras(),
                 spatial_lr_scale=scene.cameras_extent,
                 background=np.zeros(3, np.float32),
                 grad_reduce="bf16x2")
    tr.extent = scene.cameras_extent
    t0 = time.perf_counter()
    it, end = start + 1, start + iters
    metrics = None
    while it <= end:
        k = 0
        while k < FINETUNE_GROUP and it + k <= end and tr.fusible(it + k):
            k += 1
        if k:
            ms = tr.step_group(range(it, it + k))
            metrics = ms[-1]
            it += len(ms)
        else:
            metrics = tr.step(it)
            it += 1
    loss = float(metrics["loss"]) if metrics is not None else float("nan")
    if stats is not None:
        stats.update(finetune_s=time.perf_counter() - t0, loss=loss,
                     trainer=tr)
    return tr.state.pool


def main(argv=None):
    from reduced3dgs_torch import config as C
    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.models.ply_io import (
        load_gaussian_ply, pool_from_arrays, save_gaussian_ply,
    )
    from reduced3dgs_torch.ops.kmeans import produce_clusters
    from reduced3dgs_torch.scene import Scene, search_max_iteration

    parser = ArgumentParser(description="Compression script parameters "
                                        "(PyTorch port)")
    C.add_model_params(parser, fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pack_xyz", action="store_true")
    parser.add_argument("--prune_frac", type=float, default=0.0)
    parser.add_argument("--finetune_iters", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain PyTorch "
                             "versions of the kernels)")
    args = C.get_combined_args(parser, argv)
    device = resolve(args.device)

    iteration = args.iteration
    if iteration == -1:
        iteration = search_max_iteration(
            os.path.join(args.model_path, "point_cloud"))
    base = os.path.join(args.model_path, "point_cloud",
                        f"iteration_{iteration}")
    pool = pool_from_arrays(
        load_gaussian_ply(os.path.join(base, "point_cloud.ply")), device)

    if args.prune_frac > 0.0:
        n = int(pool.alive.sum())
        pool, k = prune_pool(pool, args.prune_frac)
        print(f"Pruned {k} lowest-opacity primitives ({n} -> {n - k})")
        if args.finetune_iters > 0:
            scene = Scene(C.extract_model(args), load_iteration=iteration,
                          shuffle=False)
            stats = {}
            pool = finetune(pool, scene, iteration, args.finetune_iters,
                            stats)
            tr = stats["trainer"]
            print(f"Fine-tuned {args.finetune_iters} iterations in "
                  f"{stats['finetune_s']:.3f} s "
                  f"({stats['finetune_s'] / args.finetune_iters * 1e3:.3f}"
                  f" ms per step, last loss {stats['loss']:.6f}; "
                  f"{tr.graph_captures} step graphs captured in "
                  f"{tr.capture_s:.3f} s)")

    print(f"Quantising {base} ({int(pool.num_alive)} primitives)")
    t0 = time.perf_counter()
    codebooks = produce_clusters(pool)
    print(f"Codebooks fitted in {time.perf_counter() - t0:.3f} s")
    variants = [("point_cloud_quantised.ply", False, None),
                ("point_cloud_quantised_half.ply", True, None)]
    if args.pack_xyz:
        variants.append(("point_cloud_quantised_pack.ply", True, "u16c"))
    for name, half, codec in variants:
        save_gaussian_ply(os.path.join(base, name), pool, codebooks,
                          quantised=True, half_float=half, xyz_codec=codec)
    for name in ["point_cloud.ply"] + [v[0] for v in variants]:
        size = os.path.getsize(os.path.join(base, name))
        print(f"  {name}: {size / 1e6:.2f} MB ({size} bytes)")


if __name__ == "__main__":
    main()
