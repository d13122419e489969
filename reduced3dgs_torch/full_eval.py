"""Full evaluation harness of the port: the counterpart of root
full_eval.py, composing the port's CLIs.

    python -m reduced3dgs_torch.full_eval [-e full_final ...] \\
        [--custom_scene <dir>] [--iterations N] [--dry_run] [--device cpu]

Trains, renders and scores the paper's 13 scenes (MipNeRF360 outdoor at
images_4 and indoor at images_2, Tanks&Temples, Deep Blending), or one
--custom_scene, under the reference's named experiment configurations;
`full_final` is the paper's.  Each step is one command: ``python -m
reduced3dgs_torch.train``, ``.render`` or ``.metrics`` with root
full_eval.py's flags and --device passed through.  --dry_run prints the
commands instead of running them.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump",
                             "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]

# experiment name -> extra training flags, composed as the reference does
# (full_eval.py:32-54)
_high_sh_sparsity = "--store_grads --lambda_sh_sparsity 0.1"
_sh_sparsity = "--store_grads --lambda_sh_sparsity 0.01"
_cull_sh = "--store_grads --cull_SH 15000 --std_threshold 0.04"
_mercy_points = ("--mercy_points --prune_dead_points --store_grads "
                 "--lambda_alpha_regul 0.001 "
                 "--mercy_type redundancy_opacity_opacity")
_ablation_common = " ".join([
    _high_sh_sparsity, _cull_sh, _mercy_points,
    "--std_threshold 0.04 --cdist_threshold 6"])

configurations = {
    "baseline": "",
    "high_sh_sparsity": _high_sh_sparsity,
    "sh_sparsity": _sh_sparsity,
    "cull_SH": _cull_sh,
    "mercy_points": _mercy_points,
    # Ours (the paper configuration)
    "full_final": " ".join(
        [_ablation_common, "--mercy_type redundancy_opacity_opacity"]),
    # Mercy-type ablations
    "mercy_type_opacity": " ".join(
        [_ablation_common, "--mercy_type opacity"]),
    "mercy_type_redundancy_random": " ".join(
        [_ablation_common, "--mercy_type redundancy_random"]),
    "mercy_type_redundancy_opacity": " ".join(
        [_ablation_common, "--mercy_type redundancy_opacity"]),
    # Compression-level ablations
    "high_compression": " ".join(
        [_high_sh_sparsity, _mercy_points,
         "--std_threshold 0.06 --cdist_threshold 8 --cull_SH 15000 "
         "--mercy_minimum 2 --mercy_type redundancy_opacity_opacity"]),
    "low_compression": " ".join(
        [_high_sh_sparsity, _mercy_points,
         "--cull_SH 15000 --std_threshold 0.01 "
         "--cdist_threshold 1 --mercy_type redundancy_opacity_opacity"]),
}

all_scene_names = (mipnerf360_outdoor_scenes + mipnerf360_indoor_scenes
                   + tanks_and_temples_scenes + deep_blending_scenes)


def commands(args):
    """The harness's commands in order, as strings."""
    if args.custom_scene:
        scene_name = (os.path.basename(os.path.normpath(args.custom_scene))
                      or "scene")
        scenes = [(os.path.dirname(os.path.normpath(args.custom_scene)),
                   scene_name, "")]
        wanted = [scene_name]
    else:
        scenes = (
            [(args.mipnerf360, s, "-i images_4") for s in
             mipnerf360_outdoor_scenes]
            + [(args.mipnerf360, s, "-i images_2") for s in
               mipnerf360_indoor_scenes]
            + [(args.tanksandtemples, s, "")
               for s in tanks_and_temples_scenes]
            + [(args.deepblending, s, "") for s in deep_blending_scenes])
        wanted = args.scenes
    py = f"{sys.executable} -m reduced3dgs_torch"
    dev = f" --device {args.device}"
    fps_flag = " --skip_measure_fps" if args.skip_measure_fps else ""
    it_flag = f" --iterations {args.iterations}" if args.iterations else ""
    out = []
    for config in args.experiments:
        extra = configurations[config]
        for root, scene, imgflag in scenes:
            if scene not in wanted:
                continue
            src = os.path.join(root, scene)
            model = os.path.join(args.output_path, scene, config)
            if not args.skip_training:
                out.append(f"{py}.train -s {src} {imgflag} -m {model} "
                           f"--eval --quiet{it_flag} {extra}{dev}")
            if not args.skip_rendering:
                out.append(f"{py}.render -m {model} --eval --skip_train"
                           f"{fps_flag}{dev}")
            if not args.skip_metrics:
                out.append(f"{py}.metrics -m {model}{dev}")
    return out


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--skip_measure_fps", action="store_true",
                        help="passed to the render CLI")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str,
                        default="MipNeRF360")
    parser.add_argument("--tanksandtemples", "-tat", type=str,
                        default="TanksAndTemples")
    parser.add_argument("--deepblending", "-db", type=str,
                        default="DeepBlending")
    parser.add_argument("--experiments", "-e", nargs="+", type=str,
                        default=["full_final"],
                        choices=list(configurations.keys()))
    parser.add_argument("--scenes", "-s", nargs="+", type=str,
                        default=all_scene_names, choices=all_scene_names)
    parser.add_argument("--custom_scene", type=str, default=None,
                        help="run the harness over one scene directory "
                             "instead of the paper's dataset lists")
    parser.add_argument("--iterations", type=int, default=None,
                        help="the training CLI's --iterations")
    parser.add_argument("--dry_run", action="store_true",
                        help="print the commands instead of running them")
    parser.add_argument("--device", default="cuda",
                        help="passed to every command: cuda (default) or "
                             "cpu")
    args = parser.parse_args(argv)
    for cmd in commands(args):
        if args.dry_run:
            print(cmd)
        else:
            os.system(cmd)


if __name__ == "__main__":
    main()
