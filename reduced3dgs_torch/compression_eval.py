"""End-to-end compression evaluation of the port — the counterpart of
experiments/compression_eval.py.

    python -m reduced3dgs_torch.compression_eval [--root DIR] \\
        [--iterations N] [--size S] [--n_train N] [--n_test N] [--seed S] \\
        [--train_seed S] [--skip_scene] [--skip_train] [--device cpu]

Builds the JAX script's procedural Blender-format world from --seed (a
checkerboard ground plane, three striped spheres, one sphere with
view-dependent SH, a colour-coherent clutter block), renders its ground
truth with the port's renderer (on the card unless --device cpu) into
PNGs (data/png.py), trains the plain 3DGS configuration ("vanilla") and
the paper's `full_final` scaled to 10,000 iterations ("full") through
``python -m reduced3dgs_torch.train`` subprocesses with --fused_steps 16,
then scores the four stored variants of each (baseline, quantised,
quantised_half, quantised_pack) on the test views: PSNR, SSIM, bytes and
primitives.  It prints the JAX script's table and writes it, with a JSON
copy and the stage times, to <root>/RESULTS.md and <root>/results.json;
the repository's RESULTS.md is not touched.  For the `full` model it also
prints the share of features_rest that is exactly 0 and the SH-degree
histogram after the cull.

--train_seed S is the training CLIs' --seed (their default 0): the
world stays --seed's, the trainings' random draws (camera order, split
noise, mercy's coin flips) change with it.  --iterations N scales every
iteration number of the schedule (the
iterations, densify window and interval, opacity reset, learning-rate
steps, test and save iterations, the SH cull) by N / 10,000; --size,
--n_train and --n_test shrink the scene.  The defaults are the JAX
script's.  ``python -m reduced3dgs_torch.fps_table`` then adds the FPS.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "r3dgs_torch_eval")

SH_C0 = 0.28209479177387814
GT_BUDGET = 1 << 19  # the instance budget of the ground-truth renders
EVAL_BUDGET = 1 << 21  # ... of the evaluation renders


def _dc(rgb):
    """Colour -> SH DC coefficient (render adds 0.5 after SH_C0*dc)."""
    return (np.asarray(rgb, np.float32) - 0.5) / SH_C0


def _fibonacci_sphere(n):
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                     np.sin(phi) * np.sin(theta)], 1).astype(np.float32)


def make_world(rng):
    """The procedural ground-truth Gaussians (the JAX script's numpy
    construction, draw for draw): xyz, features, scales, rotations,
    opacities and degrees.

    Spatially structured colour with a mix of structures, so that each
    reduction mechanism has something to find: a checkerboard ground
    plane (diffuse, SH bands cullable), striped opaque spheres (geometry,
    silhouettes), one 'shiny' sphere with view-dependent SH worth keeping
    and a colour-coherent dense clutter block (mercy-prunable)."""
    parts = []

    def add(xyz, rgb, scale, rest=None, opacity=4.0, scale_jitter=0.15):
        n = xyz.shape[0]
        feats = np.zeros((n, 16, 3), np.float32)
        feats[:, 0] = _dc(rgb)
        if rest is not None:
            feats[:, 1:] = rest
        s = np.full((n, 3), scale, np.float32) * np.exp(
            rng.normal(0, scale_jitter, (n, 3))).astype(np.float32)
        scales = np.log(s).astype(np.float32)
        rots = np.zeros((n, 4), np.float32)
        rots[:, 0] = 1.0
        opac = np.full(n, opacity, np.float32)
        parts.append((xyz.astype(np.float32), feats, scales, rots, opac))

    # -- checkerboard ground plane (y=-0.6), 4 tiles per checker cell --
    h = 0.036
    gx, gz = np.meshgrid(np.arange(-1.6, 1.6, h), np.arange(-1.6, 1.6, h))
    gx, gz = gx.ravel(), gz.ravel()
    ground = np.stack([gx, np.full_like(gx, -0.6), gz], 1)
    cell = (np.floor(gx / (4 * h)) + np.floor(gz / (4 * h))).astype(int) % 2
    tone = rng.uniform(-0.06, 0.06, gx.shape[0])[:, None]
    rgb = np.where(cell[:, None] == 0,
                   np.array([[0.85, 0.78, 0.55]]),
                   np.array([[0.25, 0.30, 0.40]])) + tone
    add(ground, rgb, scale=h * 0.65)

    # -- three striped opaque spheres --
    for center, rad, c0, c1, ax in [
            ((-0.65, -0.10, 0.30), 0.50, (0.85, 0.20, 0.15),
             (0.95, 0.85, 0.75), 1),
            ((0.70, 0.05, -0.45), 0.42, (0.10, 0.55, 0.20),
             (0.90, 0.90, 0.30), 0),
            ((0.15, 0.35, 0.75), 0.33, (0.15, 0.25, 0.75),
             (0.80, 0.85, 0.95), 2)]:
        n = int(3200 * (rad / 0.5) ** 2)
        p = _fibonacci_sphere(n) * rad
        stripe = (np.sin(p[:, ax] / rad * 9.0) > 0).astype(np.float32)
        rgb = (stripe[:, None] * np.array([c1])
               + (1 - stripe[:, None]) * np.array([c0]))
        add(p + np.asarray(center), rgb, scale=rad * 0.035)

    # -- shiny sphere: strong degree-1 SH (view-dependent tint) --
    n = 2600
    p = _fibonacci_sphere(n) * 0.40 + np.array([-0.15, 0.55, -0.70])
    rest = np.zeros((n, 15, 3), np.float32)
    rest[:, 0:3] = rng.normal(0, 0.45, (n, 3, 3))    # degree-1 bands
    rest[:, 3:8] = rng.normal(0, 0.10, (n, 5, 3))    # degree-2 bands
    add(p, np.tile(np.array([[0.75, 0.70, 0.65]]), (n, 1)),
        scale=0.016, rest=rest)

    # -- colour-coherent redundant clutter block (mercy fodder) --
    n = 2500
    p = rng.uniform(-0.18, 0.18, (n, 3)) + np.array([0.95, -0.35, 0.95])
    add(p, np.tile(np.array([[0.95, 0.55, 0.10]]), (n, 1)),
        scale=0.055, opacity=1.2, scale_jitter=0.3)

    world = [np.concatenate([p[i] for p in parts]) for i in range(5)]
    return world + [np.full(world[0].shape[0], 3, np.int32)]


def scene_cameras(split_offset, count, size, fov_x):
    """The JAX script's orbit of `count` views starting at angle
    `split_offset`, as port Cameras."""
    from reduced3dgs_torch.cameras import Camera

    cams = []
    for i in range(count):
        a = split_offset + i * 2 * math.pi / max(count, 1)
        r = 3.0 + 0.3 * math.sin(3 * a)
        eye = np.array([math.cos(a) * r,
                        0.5 + 0.5 * math.sin(2 * a + split_offset),
                        math.sin(a) * r])
        cams.append(Camera.look_at(eye=eye, target=(0, 0, 0), fov_x=fov_x,
                                   width=size, height=size, uid=i))
    return cams


def make_scene(root, n_train=28, n_test=4, size=384, seed=0, device=None):
    """The procedural world rendered by the port into a Blender-format
    dataset under `root` (train/ and test/ PNGs, transforms_*.json,
    points3d.ply).  Returns the largest num_rendered of the renders."""
    import torch

    from reduced3dgs_torch.data.dataset_readers import store_point_cloud_ply
    from reduced3dgs_torch.data.png import write_png
    from reduced3dgs_torch.renderer import render

    rng = np.random.default_rng(seed)
    arrs = [torch.as_tensor(a, device=device) for a in make_world(rng)]
    fov_x = math.radians(60)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    needed = 0

    def dump(split, count, offset):
        nonlocal needed
        frames = []
        for i, cam in enumerate(scene_cameras(offset, count, size, fov_x)):
            with torch.inference_mode():
                out = render(*arrs, cam.params(device),
                             torch.zeros(3, device=device), width=size,
                             height=size, instance_budget=GT_BUDGET)
            needed = max(needed, int(out.num_rendered))
            img = np.clip(out.color.cpu().numpy(), 0, 1)
            fname = f"{split}/r_{i}"
            write_png(os.path.join(root, fname + ".png"),
                      (img * 255).astype(np.uint8))
            w2c = np.eye(4)
            w2c[:3, :3] = cam.R.T
            w2c[:3, 3] = cam.T
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1
            frames.append({"file_path": fname,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov_x, "frames": frames}, f)

    dump("train", n_train, 0.0)
    dump("test", n_test, 0.26)
    pts = rng.uniform(-1.4, 1.4, (8000, 3))
    cols = (rng.uniform(0, 1, (8000, 3)) * 255).astype(np.uint8)
    store_point_cloud_ply(os.path.join(root, "points3d.ply"), pts, cols)
    return needed


ITER = 10_000

_COMMON = [
    "--eval",
    "--iterations", str(ITER),
    "--densify_from_iter", "500",
    "--densify_until_iter", "5000",
    "--densification_interval", "100",
    "--opacity_reset_interval", "3000",
    "--position_lr_max_steps", str(ITER),
    "--test_iterations", "3000", str(ITER),
    "--save_iterations", str(ITER),
    # up to 16 fusible iterations as one step group (a replayed CUDA
    # graph of the train step on the card)
    "--fused_steps", "16",
]

# Scaled full_final config (reference full_eval.py:33-44 at 30k
# iterations, here 10k with the schedule scaled to match); 'vanilla' is
# the plain 3DGS baseline the reference README compares sizes against.
CONFIGS = {
    "vanilla": [],
    "full": [
        "--store_grads",
        "--lambda_sh_sparsity", "0.1",
        "--cull_SH", "6000",
        "--mercy_points",
        "--prune_dead_points",
        "--lambda_alpha_regul", "0.001",
        "--std_threshold", "0.04",
        "--cdist_threshold", "6",
        "--mercy_type", "redundancy_opacity_opacity",
    ],
}

# the flags whose values are iteration numbers
SCHEDULE_FLAGS = ("--iterations", "--densify_from_iter",
                  "--densify_until_iter", "--densification_interval",
                  "--opacity_reset_interval", "--position_lr_max_steps",
                  "--test_iterations", "--save_iterations", "--cull_SH")

VARIANTS = (("baseline", False, False, False),
            ("quantised", True, False, False),
            ("quantised_half", True, True, False),
            ("quantised_pack", False, False, True))


def scaled(args, iterations):
    """`args` with every iteration number scaled by iterations / ITER
    (rounded, at least 1)."""
    out, scaling = [], False
    for a in args:
        if a.startswith("--"):
            scaling = a in SCHEDULE_FLAGS
            out.append(a)
        elif scaling:
            out.append(str(max(1, round(int(a) * iterations / ITER))))
        else:
            out.append(a)
    return out


def module_command(module):
    """The command line that runs `module` as a script (the training and
    render CLIs run as subprocesses)."""
    return [sys.executable, "-m", module]


def train_command(data, model, extra, iterations, device, seed=0):
    return (module_command("reduced3dgs_torch.train")
            + ["-s", data, "-m", model] + scaled(_COMMON + extra, iterations)
            + ["--seed", str(seed), "--device", str(device)])


def train(data, model, extra, iterations=ITER, device="cuda", env=None,
          seed=0):
    """One training run (training seed `seed`) as a subprocess of the
    port's training CLI; returns its train_stats.json with the run's wall
    seconds."""
    t0 = time.perf_counter()
    r = subprocess.run(train_command(data, model, extra, iterations, device,
                                     seed),
                       cwd=REPO, text=True, capture_output=True,
                       timeout=10800, env=env)
    wall = time.perf_counter() - t0
    sys.stdout.write(r.stdout[-4000:])
    sys.stderr.write(r.stderr[-4000:])
    r.check_returncode()
    with open(os.path.join(model, "train_stats.json")) as f:
        return dict(json.load(f), wall_s=wall)


def ply_path(model, iteration, tag):
    from reduced3dgs_torch.scene import ply_name

    _, q, h, p = next(v for v in VARIANTS if v[0] == tag)
    return os.path.join(model, "point_cloud", f"iteration_{iteration}",
                        ply_name(q, h, p))


def view_images(pool, cams, device, budget=EVAL_BUDGET):
    """Each camera's render of `pool` on a black background, clamped to
    [0, 1] as the JAX scripts score it, beside the camera's ground truth
    (tensors on `device`).  An overflow of `budget` raises."""
    import torch

    from reduced3dgs_torch.renderer import render

    for cam in cams:
        with torch.inference_mode():
            out = render(
                pool.params.xyz, pool.features(), pool.params.scaling,
                pool.params.rotation, pool.params.opacity[:, 0],
                pool.degrees, cam.params(device),
                torch.zeros(3, device=device), width=cam.width,
                height=cam.height, instance_budget=budget,
                alive_mask=pool.alive)
        if int(out.num_rendered) > budget:
            raise RuntimeError(f"budget overflow: {int(out.num_rendered)} "
                               f"instances for a budget of {budget}")
        yield (torch.clamp(out.color, 0, 1),
               torch.as_tensor(cam.image, device=device))


def mean_psnr(pool, cams, device, budget=EVAL_BUDGET):
    """The mean PSNR of `pool` over the cameras (view_images)."""
    from reduced3dgs_torch.ops.losses import psnr

    return float(np.mean([float(psnr(img, gt)) for img, gt in
                          view_images(pool, cams, device, budget)]))


def stored_model(root, model, iteration, device):
    """The Scene of <root>/scene with <root>/<model>'s stored full-precision
    PLY of `iteration` loaded on `device`: (scene, pool)."""
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.scene import Scene

    ds = ModelParams(source_path=os.path.join(root, "scene"),
                     model_path=os.path.join(root, model), eval=True)
    scene = Scene(ds, load_iteration=iteration, shuffle=False)
    return scene, scene.load_model(device=device)


def evaluate(data, model, iteration=ITER, device="cuda"):
    """PSNR and SSIM on the test views, bytes and primitives of each
    stored variant (experiments/compression_eval.py's evaluate, through
    the port's Scene and renderer)."""
    from reduced3dgs_torch.config import ModelParams
    from reduced3dgs_torch.ops.losses import psnr, ssim
    from reduced3dgs_torch.scene import Scene

    ds = ModelParams(source_path=data, model_path=model, eval=True)
    scene = Scene(ds, load_iteration=iteration, shuffle=False)
    results = {}
    for tag, q, h, pack in VARIANTS:
        pool = scene.load_model(quantised=q, half_float=h, pack_xyz=pack,
                                device=device)
        ps, ss = [], []
        for img, gt in view_images(pool, scene.get_test_cameras(), device):
            ps.append(float(psnr(img, gt)))
            ss.append(float(ssim(img, gt)))
        results[tag] = {
            "psnr": float(np.mean(ps)),
            "ssim": float(np.mean(ss)),
            "bytes": os.path.getsize(ply_path(model, iteration, tag)),
            "n_primitives": int(pool.alive.sum()),
        }
    return results


def sparsity_readings(model, iteration=ITER):
    """Of the stored baseline model's primitives: the share of
    features_rest coefficients exactly 0, the share among the bands each
    primitive keeps, and how many primitives have each SH degree."""
    from reduced3dgs_torch.models.ply_io import load_gaussian_ply

    arrs = load_gaussian_ply(ply_path(model, iteration, "baseline"))
    rest = np.asarray(arrs["features_rest"])
    deg = np.asarray(arrs["degrees"])
    kept = (np.arange(1, 16)[None, :] < (deg[:, None] + 1) ** 2)
    kept = np.broadcast_to(kept[:, :, None], rest.shape)
    return {"rest_zero": float((rest == 0).mean()),
            "rest_zero_kept": (float((rest[kept] == 0).mean())
                               if kept.any() else None),
            "degrees": np.bincount(deg, minlength=4).tolist()}


def table(res, iterations, size, n_train, n_test):
    """The JAX script's table (its columns and row tags) and headline."""
    van = res["vanilla"]["baseline"]
    lines = ["# RESULTS — synthetic compression evaluation (PyTorch port)",
             "",
             f"Procedural Blender-format scene (structured: checkerboard "
             f"ground, striped spheres, one view-dependent sphere, "
             f"redundant clutter block), {n_train} train / {n_test} test "
             f"views at {size}x{size}, vanilla 3DGS config vs `full_final` "
             f"scaled to {iterations} iterations "
             f"(python -m reduced3dgs_torch.compression_eval).", "",
             "| config / model | PSNR (dB) | SSIM | primitives | "
             "size (MB) | x vs vanilla PLY |",
             "|---|---|---|---|---|---|"]
    for cfg, models in res.items():
        for tag, r in models.items():
            lines.append(
                f"| {cfg} / {tag} | {r['psnr']:.2f} | {r['ssim']:.4f} | "
                f"{r['n_primitives']:,} | {r['bytes'] / 1e6:.2f} | "
                f"{van['bytes'] / r['bytes']:.1f}x |")
    fqh = res["full"]["quantised_half"]
    lines += ["",
              f"**Headline**: full_final + quantised_half is "
              f"**{van['bytes'] / fqh['bytes']:.1f}x smaller** than the "
              f"vanilla 3DGS PLY at a PSNR delta of "
              f"{fqh['psnr'] - van['psnr']:+.2f} dB "
              f"({van['n_primitives']:,} -> {fqh['n_primitives']:,} "
              f"primitives)."]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_scene", action="store_true")
    ap.add_argument("--iterations", type=int, default=ITER)
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--n_train", type=int, default=28)
    ap.add_argument("--n_test", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train_seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions "
                         "of the kernels)")
    args = ap.parse_args(argv)

    from reduced3dgs_torch.device import resolve

    device = resolve(args.device)
    it = args.iterations
    data = os.path.join(args.root, "scene")
    stages, runs = {}, {}
    if not args.skip_train:
        if not args.skip_scene:
            print("== building procedural scene", flush=True)
            t0 = time.perf_counter()
            needed = make_scene(data, args.n_train, args.n_test, args.size,
                                args.seed, device)
            stages["scene_s"] = time.perf_counter() - t0
            print(f"== scene: {stages['scene_s']:.1f} s, num_rendered up "
                  f"to {needed:,} (budget {GT_BUDGET:,})", flush=True)
        for cfg, extra in CONFIGS.items():
            model = os.path.join(args.root, f"model_{cfg}")
            if os.path.exists(ply_path(model, it, "quantised_half")):
                print(f"== training ({cfg}): already trained, skipping",
                      flush=True)  # resumable across partial runs
                continue
            print(f"== training ({cfg})", flush=True)
            runs[cfg] = train(data, model, extra, it, device,
                              seed=args.train_seed)
            stages[f"train_{cfg}_s"] = runs[cfg]["wall_s"]
            stages[f"fit_{cfg}_s"] = runs[cfg]["fit_s"]
    res = {}
    for cfg in CONFIGS:
        print(f"== evaluating ({cfg})", flush=True)
        t0 = time.perf_counter()
        res[cfg] = evaluate(data, os.path.join(args.root, f"model_{cfg}"),
                            it, device)
        stages[f"eval_{cfg}_s"] = time.perf_counter() - t0
    sparsity = sparsity_readings(os.path.join(args.root, "model_full"), it)
    lines = table(res, it, args.size, args.n_train, args.n_test)
    lines += ["", f"full / baseline: features_rest exactly 0: "
              f"{sparsity['rest_zero']:.4f} of all coefficients, "
              f"{sparsity['rest_zero_kept']} of those in each primitive's "
              f"kept bands; SH degrees 0-3 after the cull: "
              f"{sparsity['degrees']}", "",
              "Stage seconds: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in stages.items())]
    out = "\n".join(lines) + "\n"
    with open(os.path.join(args.root, "RESULTS.md"), "w") as f:
        f.write(out)
    record = {"results": res, "sparsity": sparsity, "stages": stages,
              "runs": runs, "iterations": it, "train_seed": args.train_seed,
              "device": str(device)}
    with open(os.path.join(args.root, "results.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(out)
    print(json.dumps(res))
    return record


if __name__ == "__main__":
    main()
