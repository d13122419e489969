"""Process-group set-up, a local spawner and the scaling harness.

Counterpart of reduced3dgs_tpu/parallel/launch.py.  One process per card:

  python -m reduced3dgs_torch.parallel.launch --scaling [--device cpu]
  torchrun --nproc_per_node=N -m reduced3dgs_torch.parallel.launch --scaling
  COORDINATOR=host0:8476 NPROC=4 PROC_ID=$i \\
      python -m reduced3dgs_torch.parallel.launch --scaling

``initialize_distributed`` reads the JAX package's COORDINATOR / NPROC /
PROC_ID variables or torchrun's MASTER_ADDR / RANK / WORLD_SIZE; with none
of them it creates no process group and the mesh code runs at world size
1 with identity collectives.  The backend follows the device, nccl for
cuda and gloo for cpu, and is never switched behind the caller's back.
``spawn_local`` starts world_size processes on this machine with a
``file://`` rendezvous in a temporary directory (no port to collide on).
Nothing here imports jax.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def rank_device(device: str | None, local_rank: int) -> torch.device:
    """This rank's device: cuda:(local_rank % cards) unless cpu."""
    from reduced3dgs_torch.device import resolve

    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device: str | None = None) -> torch.device:
    """Join this process to the process group the arguments or the
    environment describe, and return its device.

    The arguments default to COORDINATOR / NPROC / PROC_ID, then to
    torchrun's MASTER_ADDR (with MASTER_PORT) / WORLD_SIZE / RANK.  With no
    coordinator and no process count, no group is created (world size 1).
    device: "cpu" or None for the card (cuda:(LOCAL_RANK % cards))."""
    coordinator = coordinator or os.environ.get("COORDINATOR")
    num_processes = num_processes or _int_env("NPROC")
    if process_id is None:
        process_id = _int_env("PROC_ID")
    init_method = f"tcp://{coordinator}" if coordinator else None
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
        num_processes = num_processes or _int_env("WORLD_SIZE")
        if process_id is None:
            process_id = _int_env("RANK")
    local = _int_env("LOCAL_RANK")
    dev = rank_device(device, local if local is not None
                      else process_id or 0)
    if init_method is None and num_processes is None:
        return dev
    if init_method is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs a coordinator, a process "
                         "count and this process's id")
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                                world_size=num_processes, rank=process_id)
    return dev


# ---------------------------------------------------------------------------
# local spawner
# ---------------------------------------------------------------------------

def _spawn_entry(rank, fn, world_size, backend, device, init_file, out_dir,
                 args):
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    try:
        result = fn(rank, world_size, rank_device(device, rank), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_local(fn, world_size: int, backend: str, device: str, *args):
    """Run fn(rank, world_size, device, *args) in world_size processes of
    one process group (torch.multiprocessing.spawn, a file:// rendezvous
    in a fresh temporary directory) and return each rank's result, in rank
    order.  fn must be importable by name; results travel by torch.save.
    backend: "nccl" or "gloo", as the caller chooses."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="r3dgs_spawn_")
    try:
        mp.spawn(_spawn_entry,
                 args=(fn, world_size, backend, device,
                       os.path.join(tmp, "rendezvous"), tmp, args),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# scaling harness
# ---------------------------------------------------------------------------

def default_mesh_shapes(world: int):
    """(1, 1) on this rank alone, then the shapes of the JAX harness that
    fill the world: (1, 2), (2, 2), (2, 4)."""
    return [(1, 1)] + [s for s in ((1, 2), (2, 2), (2, 4))
                       if s[0] * s[1] == world]


def scaling_bench(widths=(512,), n_prims=1 << 15, budget=1 << 18, iters=5,
                  mesh_shapes=None, device=None, printer=print, eager=False):
    """Pixels/s of the sharded train step on each mesh shape, and the
    parallel efficiency against the (1, 1) shape of the same width; one
    JSON line per shape from rank 0.  (1, 1) runs on every rank alone (no
    collectives), a larger shape needs a world of its size.

    Per shape the step (sharded_fused_step: this rank's data member's
    camera, Adam's scalars of iteration 1) is captured once as a CUDA
    graph (its NCCL collectives inside; gloo on the card raises), warmed
    up by one replay, and `iters` replays are timed in one window with no
    host read inside (graphs.time_replays); the loss is read after the
    window.  On the CPU, or with `eager`, the same steps run eagerly in
    that loop.  The line holds root's keys, the device, ms per step, the
    capture seconds (warm-up included) and that loss.
    Returns [((n_data, n_tile), pixels_per_s), ...]."""
    import numpy as np

    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.config import OptimizationParams
    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import time_replays
    from reduced3dgs_torch.models import gaussians as G
    from reduced3dgs_torch.parallel.sharded import (
        SHARDED_METRICS, Mesh, refuse_uncapturable, sharded_fused_step,
    )
    from reduced3dgs_torch.train import adam
    from reduced3dgs_torch.train.trainer import (
        StepGraph, StepLoop, TrainState, _xyz_lr, camera_vector,
    )

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if mesh_shapes is None:
        mesh_shapes = default_mesh_shapes(world)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.0, 1.0, (n_prims, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n_prims, 3)).astype(np.float32)
    cfg = OptimizationParams()
    c1, c2 = adam.corrections(1)
    n_leaves = len(G.GaussianParams._fields)
    scalars = np.float32([_xyz_lr(1, cfg, 1.0)] + [c1] * n_leaves
                         + [c2] * n_leaves)

    results = []
    for w in widths:
        h = w
        base = None
        for nd, nt in mesh_shapes:
            pool = G.create_from_pcd(pts, cols, capacity=n_prims,
                                     device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            state = TrainState(pool, adam.init(pool.params), gen)
            mesh = Mesh(nd, nt, alone=(nd, nt) == (1, 1))
            cam = Camera.look_at(eye=(np.cos(mesh.data_idx), 0.2,
                                      -3 + 0.1 * mesh.data_idx),
                                 target=(0, 0, 0), width=w, height=h,
                                 uid=mesh.data_idx)
            vec = torch.as_tensor(np.concatenate([
                camera_vector(cam), np.zeros(3, np.float32), scalars]),
                device=dev)
            gt = torch.zeros((h, w, 3), device=dev)
            step_kw = dict(mesh=mesh, param_shard=False, width=w, height=h,
                           budget=budget, opt_cfg=cfg, grad_reduce="f32",
                           active_sh_degree=0)
            graphed = dev.type == "cuda" and not eager
            if graphed:
                refuse_uncapturable(mesh)
                run = StepGraph(state, vec, gt, step_kw, sharded_fused_step,
                                SHARDED_METRICS)
            else:
                run = StepLoop(state, step_kw, sharded_fused_step,
                               SHARDED_METRICS)
            run.buf.load(state)
            run.buf.vec.copy_(vec)
            run.buf.gt.copy_(gt)
            run.replay()  # warm-up
            dt = time_replays(run, iters, dev) / iters
            loss = float(run.buf.out_f[0])
            pps = nd * w * h / dt  # pixels/s across the mesh
            if base is None:
                base = pps / (nd * nt)
            results.append(((nd, nt), pps))
            if rank == 0:
                printer(json.dumps({
                    "mesh": f"{nd}x{nt}", "width": w, "prims": n_prims,
                    "device": str(dev), "ms_per_step": dt * 1e3,
                    "pixels_per_s": pps,
                    "efficiency_vs_1dev": pps / (base * nd * nt),
                    "capture_s": run.capture_s,
                    "loss": loss}))
            del run
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scaling", action="store_true",
                    help="run the scaling-efficiency benchmark")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--prims", type=int, default=1 << 15)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    args = ap.parse_args(argv)
    dev = initialize_distributed(device=args.device)
    try:
        if args.scaling:
            scaling_bench(widths=(args.width,), n_prims=args.prims,
                          iters=args.iters, device=dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
