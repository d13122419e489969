"""Image-quality CLI of the port — counterpart of the root metrics.py.

    python -m reduced3dgs_torch.metrics -m <model_dir> [<model_dir> ...] \\
        [--lpips_weights weights.npz] [--device cpu]

Walks ``<model_dir>/<split>/<method>/<ours>/{renders,gt}`` as
``python -m reduced3dgs_torch.render`` (or the root render.py) writes
them, scores every render against its ground truth with SSIM and PSNR
(ops/losses.py) and LPIPS (ops/lpips.py) on the device, and writes
``results.json`` (mean SSIM / PSNR / LPIPS per ``<split>_<method>/<ours>``)
and ``per_view.json`` (SSIM and PSNR per image) with the root metrics.py's
keys.  Without VGG16 weights LPIPS is reported as null; a
--lpips_weights path that does not exist raises.  On the card unless
--device cpu is given.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np


def read_images(renders_dir, gt_dir):
    """Sorted file names and their (H, W, 3) float32 renders and ground
    truths in [0, 1]."""
    from reduced3dgs_torch.data.png import read_png

    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = read_png(os.path.join(renders_dir, fname)).astype(
            np.float32) / 255.0
        g = read_png(os.path.join(gt_dir, fname)).astype(np.float32) / 255.0
        renders.append(r[:, :, :3])
        gts.append(g[:, :, :3])
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, lpips_weights=None, device=None):
    """Write results.json and per_view.json into each model directory."""
    import torch

    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.ops.losses import psnr, ssim
    from reduced3dgs_torch.ops.lpips import lpips_fn

    dev = resolve(device)
    lpips = lpips_fn(lpips_weights, dev)  # None without VGG16 weights
    if lpips is None and lpips_weights:
        raise FileNotFoundError(
            f"--lpips_weights {lpips_weights!r} not found/loadable")
    if lpips is None:
        print("LPIPS skipped (no VGG16 weights found: place an .npz at "
              "$R3DGS_LPIPS_WEIGHTS or <repo>/weights/lpips_vgg.npz; see "
              "reduced3dgs_torch/ops/lpips.py). results.json will report "
              "LPIPS: null.")

    for scene_dir in model_paths:
        print(f"Scene: {scene_dir}")
        full_dict, per_view_dict = {}, {}
        for split in ("test", "train"):
            split_dir = os.path.join(scene_dir, split)
            if not os.path.isdir(split_dir):
                continue
            for method_dir_name in os.listdir(split_dir):
                method_root = os.path.join(split_dir, method_dir_name)
                for ours in sorted(os.listdir(method_root)):
                    method = f"{method_dir_name}/{ours}"
                    base = os.path.join(method_root, ours)
                    renders_dir = os.path.join(base, "renders")
                    if not os.path.isdir(renders_dir):
                        continue
                    renders, gts, names = read_images(
                        renders_dir, os.path.join(base, "gt"))
                    ssims, psnrs, lpipss = [], [], []
                    for r, g in zip(renders, gts):
                        r = torch.as_tensor(r, device=dev)
                        g = torch.as_tensor(g, device=dev)
                        ssims.append(float(ssim(r, g)))
                        psnrs.append(float(psnr(r, g)))
                        if lpips is not None:
                            lpipss.append(float(lpips(r, g)))
                    print(f"  {split}/{method}: "
                          f"SSIM {np.mean(ssims):.7f} "
                          f"PSNR {np.mean(psnrs):.7f} "
                          + (f"LPIPS {np.mean(lpipss):.7f}"
                             if lpipss else "LPIPS n/a"))
                    key = f"{split}_{method}"
                    full_dict[key] = {
                        "SSIM": float(np.mean(ssims)),
                        "PSNR": float(np.mean(psnrs)),
                        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
                    }
                    per_view_dict[key] = {
                        "SSIM": dict(zip(names, map(float, ssims))),
                        "PSNR": dict(zip(names, map(float, psnrs))),
                    }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict, f, indent=2)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict, f, indent=2)


def main(argv=None):
    parser = ArgumentParser(description="Metrics script parameters "
                                        "(PyTorch port)")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help=".npz of VGG16 + LPIPS weights (see "
                             "reduced3dgs_torch/ops/lpips.py)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, lpips_weights=args.lpips_weights,
             device=args.device)


if __name__ == "__main__":
    main()
