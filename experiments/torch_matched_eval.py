#!/usr/bin/env python
"""The JAX package and the PyTorch port trained on one world from the same
flags on the CPU, each model scored by its own package: the matched
comparison behind the port's evaluation gap.

    JAX_PLATFORMS=cpu python experiments/torch_matched_eval.py \
        --root DIR [--size 64] [--iterations 2000] [--seeds 0 1 2] \
        [--jobs 4] [--threads 2] [--skip_train]

1. The world: reduced3dgs_torch.compression_eval.make_scene on the CPU at
   --size, 28 train / 4 test views, into <root>/scene (kept if present).
2. Trainings: for each package, configuration (vanilla, full) and
   training seed (the CLIs' --seed), the training CLI with
   compression_eval's schedule scaled to --iterations: root train.py
   --backend pallas (the Pallas kernels in interpret mode) and python -m
   reduced3dgs_torch.train --device cpu --backend tile (the kernels' plain
   versions), --jobs processes at a time with --threads threads each, into
   <root>/<package>_<config>_s<seed>.  The oracle backends ("xla", "ref")
   composite every pixel against every instance of the budget: at 64x64
   with ~60k primitives one training step asks 16-110 GB.
3. Scoring: each model's four stored variants by its own package,
   experiments/compression_eval.py's evaluate (its ITER set to
   --iterations) and reduced3dgs_torch.compression_eval.evaluate.
4. The half-float ablation of each model by each package:
   experiments/half_float_ablation.py (run through a root of links whose
   iteration_10000 is the model's iteration folder, the script's fixed
   ITER) and python -m reduced3dgs_torch.half_float_ablation --device
   cpu.

It writes <root>/matched.json (per package, configuration, variant and
seed: PSNR, SSIM, bytes, primitives; the ablation rows; each row's mean
and spread over the seeds trained) and prints the table.  Each model's
scores are kept beside it (matched_scores.json) and read back by a later
run; a model not trained (with --skip_train) is left out and named.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PACKAGES = ("jax", "torch")
CONFIGS = ("vanilla", "full")
JAX_ITER = 10_000  # experiments/half_float_ablation.py's fixed iteration


def _env(threads):
    env = dict(os.environ, OMP_NUM_THREADS=str(threads), JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                        f"intra_op_parallelism_threads={threads}")
    return env


def train_command(pkg, cfg, seed, data, model, iterations):
    from reduced3dgs_torch import compression_eval as ce

    flags = ce.scaled(ce._COMMON + ce.CONFIGS[cfg], iterations)
    if pkg == "jax":
        return ([sys.executable, os.path.join(REPO, "train.py"), "-s", data,
                 "-m", model] + flags
                + ["--backend", "pallas", "--seed", str(seed)])
    return ([sys.executable, "-m", "reduced3dgs_torch.train", "-s", data,
             "-m", model] + flags
            + ["--device", "cpu", "--backend", "tile", "--seed", str(seed)])


def run_logged(cmd, log, env):
    with open(log, "w") as f:
        r = subprocess.run(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                           env=env)
    if r.returncode:
        raise RuntimeError(f"{' '.join(cmd[:3])} failed; see {log}")


def model_dir(root, pkg, cfg, seed):
    return os.path.join(root, f"{pkg}_{cfg}_s{seed}")


def jax_script(name):
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def jax_ablation(root, data, model, iterations, env):
    """experiments/half_float_ablation.py on `model` through a root of
    links (scene, model_full/point_cloud/iteration_10000)."""
    links = os.path.join(root, "ablation_links", "jax_" +
                         os.path.basename(model))
    pc = os.path.join(links, "model_full", "point_cloud")
    os.makedirs(pc, exist_ok=True)
    for src, dst in ((data, os.path.join(links, "scene")),
                     (os.path.join(model, "point_cloud",
                                   f"iteration_{iterations}"),
                      os.path.join(pc, f"iteration_{JAX_ITER}"))):
        if not os.path.lexists(dst):
            os.symlink(os.path.abspath(src), dst)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "experiments",
                                      "half_float_ablation.py"),
         "--root", links], cwd=REPO, capture_output=True, text=True,
        env=env, check=True)
    return json.loads(r.stdout[r.stdout.index("{"):])["psnr"]


def torch_ablation(root, model, iterations, env):
    links = os.path.join(root, "ablation_links", "torch_" +
                         os.path.basename(model))
    os.makedirs(links, exist_ok=True)
    for name, src in (("scene", os.path.join(root, "scene")),
                      ("model_full", model)):
        if not os.path.lexists(os.path.join(links, name)):
            os.symlink(os.path.abspath(src), os.path.join(links, name))
    subprocess.run([sys.executable, "-m",
                    "reduced3dgs_torch.half_float_ablation", "--root", links,
                    "--iterations", str(iterations), "--device", "cpu"],
                   cwd=REPO, capture_output=True, text=True, env=env,
                   check=True)
    with open(os.path.join(links, "half_float_ablation.json")) as f:
        return json.load(f)["psnr"]


def score(root, pkg, model, iterations, env):
    """The four variants' scores and the ablation rows of one model by its
    own package, kept in <model>/matched_scores.json (read back if there,
    so that a model is scored once as soon as it is trained)."""
    import torch

    from reduced3dgs_torch import compression_eval as tce

    cache = os.path.join(model, "matched_scores.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    data = os.path.join(root, "scene")
    if pkg == "jax":
        jce = jax_script("compression_eval")
        jce.ITER = iterations
        got = {"variants": jce.evaluate(data, model),
               "ablation": jax_ablation(root, data, model, iterations, env)}
    else:
        got = {"variants": tce.evaluate(data, model, iterations,
                                        torch.device("cpu")),
               "ablation": torch_ablation(root, model, iterations, env)}
    with open(cache, "w") as f:
        json.dump(got, f, indent=1)
    return got


def spread(values):
    v = np.array(values, np.float64)
    return {"mean": float(v.mean()), "spread": float(v.max() - v.min()),
            "std": float(v.std(ddof=1)) if v.size > 1 else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--skip_train", action="store_true")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from reduced3dgs_torch import compression_eval as tce

    torch.set_num_threads(args.threads * args.jobs)
    data = os.path.join(args.root, "scene")
    env = _env(args.threads)
    runs = [(p, c, s) for s in args.seeds for c in CONFIGS for p in PACKAGES]
    if not args.skip_train:
        if not os.path.exists(os.path.join(data, "transforms_test.json")):
            tce.make_scene(data, 28, 4, args.size, 0, "cpu")
        os.makedirs(os.path.join(args.root, "logs"), exist_ok=True)

        def one(run):
            p, c, s = run
            m = model_dir(args.root, p, c, s)
            if not os.path.exists(tce.ply_path(m, args.iterations,
                                               "quantised_half")):
                run_logged(train_command(p, c, s, data, m, args.iterations),
                           os.path.join(args.root, "logs",
                                        f"{p}_{c}_s{s}.log"), env)

        with ThreadPoolExecutor(args.jobs) as pool:
            for f in [pool.submit(one, r) for r in runs]:
                f.result()

    scores, ablation = {}, {}
    for p, c, s in runs:
        m = model_dir(args.root, p, c, s)
        if not os.path.exists(tce.ply_path(m, args.iterations, "baseline")):
            print(f"not trained: {p} {c} seed {s}", flush=True)
            continue
        got = score(args.root, p, m, args.iterations, env)
        scores.setdefault(p, {}).setdefault(c, {})[s] = got["variants"]
        ablation.setdefault(p, {}).setdefault(c, {})[s] = got["ablation"]
        print(f"scored {p} {c} seed {s}", flush=True)

    table = {}
    for p in scores:
        for c in scores[p]:
            seeds = sorted(scores[p][c])
            for tag in tce.VARIANTS:
                vals = [scores[p][c][s][tag[0]]["psnr"] for s in seeds]
                table[f"{p} {c}/{tag[0]}"] = dict(
                    spread(vals), psnr=dict(zip(seeds, vals)))
            for row in ablation[p][c][seeds[0]]:
                vals = [ablation[p][c][s][row] for s in seeds]
                table[f"{p} {c} ablation/{row}"] = dict(
                    spread(vals), psnr=dict(zip(seeds, vals)))
    record = {"args": vars(args), "scores": scores, "ablation": ablation,
              "table": table}
    with open(os.path.join(args.root, "matched.json"), "w") as f:
        json.dump(record, f, indent=1)
    for row, r in table.items():
        print(f"{row:<40} " + " ".join(f"{v:.3f}" for v in r["psnr"].values())
              + f"  mean {r['mean']:.3f} spread {r['spread']:.3f}")


if __name__ == "__main__":
    main()
