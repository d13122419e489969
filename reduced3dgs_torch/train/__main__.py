"""Training CLI of the port — counterpart of the root train.py.

    python -m reduced3dgs_torch.train -s <scene> [-m <model_dir>] \\
        [--iterations N] [--grad_reduce bf16x2|f32] [--fused_steps K] \\
        [--checkpoint_iterations N ...] [--start_checkpoint chkpntN.npz] \\
        [--trace] [--device cpu]

Same flags, loop and saves as train.py (point_cloud/iteration_N/
point_cloud.ply at every --save_iterations entry), on the card unless
--device cpu is given, including --mercy_points and --cull_SH, and ending
with train.py's final compression: the k-means codebooks and the four
PLYs point_cloud.ply, point_cloud_quantised.ply,
point_cloud_quantised_half.ply and point_cloud_quantised_pack.ply of the
last iteration.  --fused_steps K runs up to K fusible iterations as one
Trainer.step_group (a replayed CUDA graph of the train step on the card),
never across a test, checkpoint or save iteration, with K rounded down to
a power of two so that few group lengths occur; the per-iteration logging
replays after the group.  --checkpoint_iterations writes
<model_dir>/chkpntN.npz (train/checkpoint.py, the JAX package's layout)
and --start_checkpoint resumes from one.  --variable_sh_bands is
accepted, recorded in cfg_args and ignored, as train.py does (a rendering
option; see reduced3dgs_torch.render).
At the end it writes <model_dir>/train_stats.json: the seconds of
training and of the codebook fit, the files' bytes, how often each
surgery ran, the iterations run in step groups, the graphs captured and
the kernels' launches inside their replays and in the process; with
--trace (utils/profiling.py on for the whole run) also, under "trace",
the stage clock's seconds per stage, the host spans and the counters
(among them the binning's pad need against its slack pool and the
budget redos).
--ip / --port open the SIBR viewer bridge (network_gui.py), polled at
the top of every iteration or step group as train.py does; if the port
cannot be bound it prints "Network GUI disabled" and training goes on.
No TensorBoard.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time
import uuid
from argparse import ArgumentParser, Namespace

import numpy as np

# the stored variants of the final compression: (quantise, half_float,
# pack_xyz) as Scene.save takes them
FINAL_VARIANTS = ((False, False, False), (True, False, False),
                  (True, True, False), (True, True, True))


def build_parser():
    from reduced3dgs_torch import config as C

    parser = ArgumentParser(
        description="Training script parameters (PyTorch port)")
    C.add_model_params(parser)
    C.add_optimization_params(parser)
    C.add_pipeline_params(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--cull_SH", nargs="+", type=int, default=[])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain PyTorch "
                             "versions of the kernels)")
    parser.add_argument("--trace", action="store_true",
                        help="trace the run (stage clock, spans, counters) "
                             "into train_stats.json")
    return parser


def cfg_namespace(args):
    """The Namespace that cfg_args records: root train.py's for the same
    command line, so without the port's --device (a run option, not a
    model setting; nor --trace).  --variable_sh_bands is kept and ignored
    as root keeps and ignores it: it is a rendering option."""
    return Namespace(**{k: v for k, v in vars(args).items()
                        if k not in ("device", "trace")})


def final_compression(scene, iteration, max_sh_degree=3, stats=None):
    """The end of training: save ``scene.pool`` plain, fit the 20
    codebooks (ops/kmeans.py) and save the quantised, quantised_half and
    quantised_pack variants.  Returns the four paths in that order.
    stats: a dict that receives the fit's seconds ("fit_s"), each
    codebook's Lloyd steps ("lloyd_steps") and the files' sizes in bytes
    ("bytes", by file name)."""
    from reduced3dgs_torch.ops.kmeans import produce_clusters

    paths = [scene.save(iteration)]
    steps = {}
    t0 = time.perf_counter()
    codebooks = produce_clusters(scene.pool, max_sh_degree=max_sh_degree,
                                 stats=steps)
    fit_s = time.perf_counter() - t0
    for quantise, half_float, pack_xyz in FINAL_VARIANTS[1:]:
        paths.append(scene.save(iteration, codebooks, quantise=quantise,
                                half_float=half_float, pack_xyz=pack_xyz))
    if stats is not None:
        stats.update(fit_s=fit_s, lloyd_steps=steps, bytes={
            os.path.basename(p): os.path.getsize(p) for p in paths})
    return paths


def main(argv=None):
    import torch

    from reduced3dgs_torch import config as C
    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import (
        all_kernel_counters, log_launches_at_exit,
    )

    from reduced3dgs_torch.utils import profiling

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve(args.device)
    log_launches_at_exit("train")
    tracer = profiling.enable() if args.trace else None
    args.save_iterations.append(args.iterations)
    dataset = C.extract_model(args)
    opt = C.extract_optimization(args)
    pipe = C.extract_pipeline(args)

    if not args.model_path:
        args.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
        dataset = dataset.__class__(**{**dataset.__dict__,
                                       "model_path": args.model_path})
    print(f"Optimizing {args.model_path} on {device}")
    os.makedirs(args.model_path, exist_ok=True)
    C.dump_cfg_args(args.model_path, cfg_namespace(args))

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    from reduced3dgs_torch.network_gui import NetworkGUI
    from reduced3dgs_torch.ops.losses import psnr
    from reduced3dgs_torch.renderer import render
    from reduced3dgs_torch.scene import Scene
    from reduced3dgs_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from reduced3dgs_torch.train.trainer import Trainer, prune_dead_step

    scene = Scene(dataset, load_iteration=None, device=device)
    background = torch.tensor(
        [1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
        device=device)
    backend = ("ref" if (pipe.convert_SHs_python
                         or pipe.compute_cov3D_python) else pipe.backend)
    trainer = Trainer(
        scene.pool, opt, scene.get_train_cameras(),
        spatial_lr_scale=scene.cameras_extent, background=background,
        backend=backend, max_sh_degree=dataset.sh_degree, seed=args.seed,
        cull_sh_iterations=args.cull_SH, scene=scene,
        white_background=dataset.white_background,
        grad_reduce=pipe.grad_reduce)
    trainer.extent = scene.cameras_extent
    first_iter = 0
    if args.start_checkpoint:
        trainer.state, first_iter, trainer.spatial_lr_scale = (
            load_checkpoint(args.start_checkpoint, device))
        print(f"Resuming from {args.start_checkpoint} at iteration "
              f"{first_iter}")
    gui = NetworkGUI(args.ip, args.port, dataset.source_path, trainer, pipe,
                     background)

    def eval_report(iteration):
        train_cams = scene.get_train_cameras()
        sample = ([train_cams[i % len(train_cams)]
                   for i in range(5, 30, 5)] if train_cams else [])
        pool = trainer.state.pool
        for name, cams in [("test", scene.get_test_cameras()),
                           ("train", sample)]:
            if not cams:
                continue
            ps, l1s = [], []
            for cam in cams:
                with torch.inference_mode():
                    out = render(
                        pool.params.xyz, pool.features(),
                        pool.params.scaling, pool.params.rotation,
                        pool.params.opacity[:, 0], pool.degrees,
                        cam.params(device), background, width=cam.width,
                        height=cam.height,
                        instance_budget=trainer._budget_for(cam.uid),
                        alive_mask=pool.alive, backend=backend)
                gt = torch.as_tensor(np.clip(cam.image, 0, 1),
                                     device=device)
                img = torch.clamp(out.color, 0, 1)
                ps.append(float(psnr(img, gt)))
                l1s.append(float((img - gt).abs().mean()))
            print(f"\n[ITER {iteration}] Evaluating {name}: "
                  f"L1 {np.mean(l1s):.5f} PSNR {np.mean(ps):.2f}")

    ema = 0.0

    def post_step(iteration, metrics):
        nonlocal ema
        if iteration % 10 == 0 or iteration == opt.iterations:
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                snap = os.path.join(args.model_path, "snapshot_fw.npz")
                pool = trainer.state.pool
                np.savez(snap, iteration=iteration,
                         **{f"param_{k}": v.cpu().numpy() for k, v in
                            pool.params._asdict().items()},
                         alive=pool.alive.cpu().numpy(),
                         degrees=pool.degrees.cpu().numpy())
                raise FloatingPointError(
                    f"non-finite loss at iteration {iteration}; state "
                    f"snapshot written to {snap}")
            ema = 0.4 * loss + 0.6 * ema
            if not args.quiet:
                print(f"[ITER {iteration}] loss {ema:.7f} "
                      f"N {int(metrics['num_alive'])}", flush=True)
        if iteration in args.test_iterations:
            eval_report(iteration)
        if iteration in args.checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            save_checkpoint(
                os.path.join(args.model_path, f"chkpnt{iteration}.npz"),
                trainer.state, iteration, trainer.spatial_lr_scale)
        if iteration in args.save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            if opt.prune_dead_points:
                trainer.state, _ = prune_dead_step(
                    trainer.state, float(trainer.extent))
            scene.pool = trainer.state.pool
            scene.save(iteration)

    # groups of up to --fused_steps fusible iterations; an iteration whose
    # state a test, checkpoint or save must see ends its group
    fused = max(1, int(pipe.fused_steps))
    host_bounds = (set(args.test_iterations) | set(args.checkpoint_iterations)
                   | set(args.save_iterations))
    t_start = time.perf_counter()
    iteration = first_iter + 1
    while iteration <= opt.iterations:
        gui.poll(iteration)
        k = 1
        if fused > 1 and trainer.fusible(iteration):
            while (k < fused and iteration + k <= opt.iterations
                   and trainer.fusible(iteration + k)
                   and (iteration + k - 1) not in host_bounds):
                k += 1
            k = 1 << (k.bit_length() - 1)
        if k > 1:
            ms = trainer.step_group(range(iteration, iteration + k))
            for j, m in enumerate(ms):
                post_step(iteration + j, m)
            iteration += len(ms)
        else:
            post_step(iteration, trainer.step(iteration))
            iteration += 1

    gui.close()
    scene.pool = trainer.state.pool
    t_train = time.perf_counter() - t_start
    stats = {}
    final_compression(scene, opt.iterations, dataset.sh_degree, stats)
    sizes = ", ".join(f"{k} {v}" for k, v in stats["bytes"].items())
    print(f"\nFinal compression: codebooks fitted in {stats['fit_s']:.1f} s;"
          f" bytes: {sizes}")
    summary = dict(
        iterations=opt.iterations, train_s=t_train, fit_s=stats["fit_s"],
        tests_run=len({i for i in args.test_iterations
                       if first_iter < i <= opt.iterations}),
        bytes=stats["bytes"], events=trainer.events,
        grouped_steps=trainer.grouped_steps,
        graph_captures=trainer.graph_captures,
        capture_s=trainer.capture_s, graph_launches=trainer.graph_launches,
        launches={n: k.launches for n, k in all_kernel_counters().items()})
    if tracer is not None:
        summary["trace"] = profiling.snapshot()
        tracer.close()
    with open(os.path.join(args.model_path, "train_stats.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"Surgeries {trainer.events}; {trainer.grouped_steps} of "
          f"{opt.iterations - first_iter} iterations in step groups "
          f"({trainer.graph_captures} graphs captured in "
          f"{trainer.capture_s:.1f} s); summary in train_stats.json")
    print(f"\nTraining complete in {t_train:.1f} s.")


if __name__ == "__main__":
    main()
