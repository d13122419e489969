"""A/B evidence for the bf16x2 gradient reduction — the counterpart of
experiments/grad_reduce_ab.py.

    python -m reduced3dgs_torch.grad_reduce_ab [iters] [--root DIR] \\
        [--arms f32 f32_s2 bf16x2 bf16x2_s2] [--device cpu]

The per-primitive reduction of the nine gradient columns runs in f32 (K5,
csrc/seg_reduce.cu) or on bf16-rounded pairs (K6, the training default).
This measures what the rounding costs, on the JAX script's procedural
world (rng 7: 3,000 colour-coherent blobs rendered by the port at
256x256 from 14 orbit views, every seventh held out):

1. one-step gradient error: the relative L2 of the bf16x2 against the f32
   gradient of each parameter leaf, for the L1 loss of one training view
   of a 20,000-point pool;
2. training quality: `iters` eager Trainer.step iterations (densify every
   100 from 100, no opacity reset) in the arms f32 / bf16x2 with seeds 1
   and 2 (f32_s2, bf16x2_s2), each from its own 4,000-point pool, scored
   by held-out PSNR.

Every random draw is the JAX script's, in its order (the arms' points are
drawn for all four arms, so an arm given alone starts where it would in
the full run).  It prints the JAX script's JSON (one_step_grad_rel_l2,
test_psnr, psnr_delta_db, seed_noise_db where both arms ran, iters) with
the device and seconds, and writes it to <root>/grad_reduce_ab.json.  On
the card unless --device cpu is given.

Part 1 renders the pool with its alive mask.  The JAX script renders the
whole capacity (2^15 slots): its 12,768 dead slots, unit-scale grey
Gaussians at the origin, fill most of the instance budget and the image,
so its one-step errors describe those slots rather than the pool.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

from reduced3dgs_torch.compression_eval import DEFAULT_ROOT, mean_psnr

SIZE = 256  # width and height of every view
BUDGET = 1 << 19  # instance budget of every render
N_GT = 3000  # ground-truth Gaussians
N_VIEWS = 14
N_PART1 = 20000  # points of part 1's pool
N_ARM = 4000  # points of each training arm's initial pool
CAPACITY = 1 << 15
ARMS = (("f32", 1), ("f32_s2", 2), ("bf16x2", 1), ("bf16x2_s2", 2))
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def make_world(rng):
    """The ground-truth Gaussians (xyz, features, log scales, rotations,
    opacities, degrees; numpy), the JAX script's draws."""
    centers = rng.uniform(-1.0, 1.0, (40, 3)).astype(np.float32)
    col_c = rng.uniform(0.1, 0.9, (40, 3)).astype(np.float32)
    which = rng.integers(0, 40, N_GT)
    xyz = centers[which] + rng.normal(0, 0.15, (N_GT, 3)).astype(np.float32)
    feats = np.zeros((N_GT, 16, 3), np.float32)
    feats[:, 0] = (col_c[which]
                   + rng.normal(0, 0.05, (N_GT, 3)) - 0.5) / 0.2820948
    scales = np.log(rng.uniform(0.02, 0.08, (N_GT, 3))).astype(np.float32)
    rots = rng.normal(0, 1, (N_GT, 4)).astype(np.float32)
    opac = rng.uniform(0.5, 3.0, N_GT).astype(np.float32)
    return xyz, feats, scales, rots, opac, np.zeros(N_GT, np.int32)


def make_cameras():
    """The 14 orbit views (radius 3.2, height 0.9)."""
    from reduced3dgs_torch.cameras import Camera

    return [Camera.look_at(
        eye=(math.cos(a) * 3.2, 0.9, math.sin(a) * 3.2), target=(0, 0, 0),
        width=SIZE, height=SIZE, uid=i)
        for i, a in enumerate(np.linspace(0, 2 * math.pi, N_VIEWS,
                                          endpoint=False))]


def render_ground_truth(world, cams, device):
    """Each camera's image of the world (clipped to [0, 1]) as its
    ground truth."""
    import torch

    from reduced3dgs_torch.renderer import render

    arrs = [torch.as_tensor(a, device=device) for a in world]
    for cam in cams:
        with torch.inference_mode():
            out = render(*arrs, cam.params(device),
                         torch.zeros(3, device=device), width=SIZE,
                         height=SIZE, instance_budget=BUDGET)
        cam.image = np.clip(out.color.cpu().numpy(), 0, 1)


def grad_rel_l2(pool, cam, device):
    """Per parameter leaf, ||g_bf16x2 - g_f32|| / ||g_f32|| (0 where the
    f32 gradient is 0) of the L1 loss of `cam`'s render of the pool
    (its alive rows) against the camera's image."""
    import torch

    from reduced3dgs_torch.renderer import render

    cp = cam.params(device)
    gt = torch.as_tensor(cam.image, device=device)
    grads = {}
    for mode in ("f32", "bf16x2"):
        leaves = [getattr(pool.params, k).detach().clone().requires_grad_()
                  for k in PARAMS]
        p = dict(zip(PARAMS, leaves))
        out = render(p["xyz"], torch.cat([p["features_dc"],
                                          p["features_rest"]], 1),
                     p["scaling"], p["rotation"], p["opacity"][:, 0],
                     pool.degrees, cp, torch.zeros(3, device=device),
                     width=cam.width, height=cam.height,
                     instance_budget=BUDGET,
                     alive_mask=pool.alive, grad_reduce=mode)
        loss = (out.color - gt).abs().mean()
        grads[mode] = torch.autograd.grad(loss, leaves)
    errs = {}
    for k, a, b in zip(PARAMS, grads["f32"], grads["bf16x2"]):
        denom = float(torch.linalg.vector_norm(a))
        errs[k] = (float(torch.linalg.vector_norm(b - a)) / denom
                   if denom else 0.0)
    return errs


def train_arm(pool, mode, seed, iters, train_cams, test_cams, device):
    """`iters` Trainer.step iterations of the JAX script's schedule with
    the `mode` reduction from `pool`; returns the held-out mean PSNR."""
    import torch

    from reduced3dgs_torch.config import OptimizationParams
    from reduced3dgs_torch.train.trainer import Trainer

    cfg = dataclasses.replace(
        OptimizationParams(), iterations=iters,
        densify_from_iter=100, densification_interval=100,
        densify_until_iter=max(iters - 100, 150),
        opacity_reset_interval=10 ** 9)
    tr = Trainer(pool, cfg, train_cams, spatial_lr_scale=1.0,
                 background=torch.zeros(3), backend="tile",
                 initial_budget=BUDGET, seed=seed,
                 grad_reduce=mode.split("_")[0])
    tr.extent = 3.2
    for it in range(1, iters + 1):
        m = tr.step(it)
        if it % max(iters // 8, 1) == 0:
            print(f"[{mode}] iter {it}: loss {float(m['loss']):.4f} pts "
                  f"{int(tr.state.pool.num_alive)}", flush=True)
    return mean_psnr(tr.state.pool, test_cams, device, BUDGET)


def run(iters, arms, device):
    """Both parts; returns the JAX script's record."""
    from reduced3dgs_torch.models import gaussians as G

    rng = np.random.default_rng(7)
    cams = make_cameras()
    render_ground_truth(make_world(rng), cams, device)
    test_cams = cams[::7]
    train_cams = [c for i, c in enumerate(cams) if i % 7]

    def points(n):
        return (rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32),
                rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32))

    pool = G.create_from_pcd(*points(N_PART1), capacity=CAPACITY,
                             device=device)
    errs = grad_rel_l2(pool, train_cams[0], device)
    starts = {mode: points(N_ARM) for mode, _ in ARMS}
    results = {}
    for mode, seed in ARMS:
        if mode in arms:
            pool = G.create_from_pcd(*starts[mode], capacity=CAPACITY,
                                     device=device)
            results[mode] = train_arm(pool, mode, seed, iters, train_cams,
                                      test_cams, device)
    out = {"one_step_grad_rel_l2": errs, "test_psnr": results}
    if {"f32", "bf16x2"} <= set(results):
        out["psnr_delta_db"] = results["bf16x2"] - results["f32"]
    if {"f32", "f32_s2"} <= set(results):
        out["seed_noise_db"] = abs(results["f32_s2"] - results["f32"])
    out["iters"] = iters
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=400)
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--arms", nargs="+", default=[a for a, _ in ARMS],
                    choices=[a for a, _ in ARMS])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import log_launches_at_exit

    device = resolve(args.device)
    log_launches_at_exit("grad_reduce_ab")
    t0 = time.perf_counter()
    out = run(args.iters, args.arms, device)
    out.update(device=str(device), seconds=time.perf_counter() - t0)
    print(json.dumps(out, indent=2))
    os.makedirs(args.root, exist_ok=True)
    with open(os.path.join(args.root, "grad_reduce_ab.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
