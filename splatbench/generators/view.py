"""The `view` traffic: one viewer in a closed loop, each request one frame
at the next pose of a smooth seeded camera path, through the program's
serving path (render.py): a PoolView, and render_once captured as a
graphs.runner that reads its camera from a device vector.

Per frame the harness copies the pose from pinned host memory into that
vector, replays the graph and reads num_rendered once on the host.  A
frame whose instances overflow the budget climbs next_budget's ladder,
is captured again and rendered again; all of it counts in that frame's
latency.  Set-up loads the model (a stored `quantised_half` file through
the program's loader, or the seeded primitives as a pool), settles the
budget over a sample of the path as settle_budget does, and captures the
frame.
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from contextlib import nullcontext

import numpy as np
import torch

from splatbench import quantised, scene
from splatbench.generators.train import view_of
from splatbench.reference import full_precision, raster
from splatbench.reference.dequant import dequantise

LEAVES = scene.LEAVES


def model_inputs(cfg, seed: int, device):
    """(leaves over the capacity, and for a stored model its codebooks,
    indices and float16 positions)."""
    leaves = scene.primitives(cfg, seed, device)
    if cfg.get("stored") != "quantised_half":
        return leaves, None
    n = cfg["primitives"]
    return leaves, quantised.quantise(leaves, n)


class View:
    """One cell's viewer: the loaded model, the frame graph and the path."""

    def __init__(self, cfg, traffic, seed: int, device):
        from reduced3dgs_torch.cameras import Camera
        from reduced3dgs_torch.models.gaussians import (
            GaussianParams, GaussianPool,
        )
        from reduced3dgs_torch.render import PoolView, settle_budget
        from reduced3dgs_torch.train.trainer import camera_vector

        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        w, h = cfg["width"], cfg["height"]
        leaves, stored = model_inputs(cfg, seed, device)
        variable_sh = stored is not None
        if stored is not None:
            from reduced3dgs_torch.models.ply_io import (
                load_gaussian_ply, pool_from_arrays,
            )

            books, ids, xyz = stored
            n = cfg["primitives"]
            fd, path = tempfile.mkstemp(suffix=".ply")
            os.close(fd)
            try:
                quantised.write(path, books, ids, xyz, leaves["degrees"][:n])
                arrs = load_gaussian_ply(path, quantised=True,
                                         half_float=True)
            finally:
                os.remove(path)
            pool = pool_from_arrays(arrs, device, capacity=cfg["capacity"])
        else:
            pool = GaussianPool(
                params=GaussianParams(*(leaves[k] for k in LEAVES)),
                degrees=leaves["degrees"], alive=leaves["alive"],
                active_sh_degree=cfg["sh_degree"])
        del leaves
        self.pv = PoolView(pool, variable_sh=variable_sh)
        self.stored = stored
        fov_x = np.radians(cfg["assumed"]["fov_x_deg"])
        fov_y = scene.fov_y(cfg)
        self.poses = scene.viewing_path(cfg, seed, traffic["poses"])
        cams = [Camera(uid=i, colmap_id=i, R=R, T=T, fov_x=fov_x,
                       fov_y=fov_y, image=None, image_name=f"{i:05d}",
                       width=w, height=h)
                for i, (R, T, _) in enumerate(self.poses)]
        vecs = np.stack([camera_vector(c) for c in cams])
        self.host = torch.as_tensor(vecs)
        if device.type == "cuda":
            self.host = self.host.pin_memory()
        self.vec = torch.zeros(vecs.shape[1], device=device)
        self.bg = torch.zeros(3, device=device)
        sample = [c.params(device) for c in cams[::traffic["settle_every"]]]
        self.budget, _ = settle_budget(self.pv, sample, self.bg,
                                       traffic["start_budget"])
        self.runner = self._capture()
        self.next_pose = 0
        self.recaptures = 0
        self.kept = {}

    def _capture(self):
        from reduced3dgs_torch import graphs
        from reduced3dgs_torch.render import render_once
        from reduced3dgs_torch.train.trainer import camera_from_vector

        cp = camera_from_vector(self.vec, self.cfg["width"],
                                self.cfg["height"])
        self.vec.copy_(self.host[0])
        return graphs.runner(
            lambda: render_once(self.pv, cp, self.bg, self.budget),
            self.dev)

    def frame(self, keep: bool = False):
        """One request: the next pose's frame; returns its pose index.
        keep: a copy of the frame is kept for the check."""
        from reduced3dgs_torch.render import next_budget

        i = self.next_pose
        self.next_pose = (i + 1) % len(self.poses)
        self.vec.copy_(self.host[i], non_blocking=True)
        self.runner.replay()
        need = int(self.runner.out.num_rendered)
        while need > self.budget:
            self.budget = next_budget(self.budget, need)
            self.runner = self._capture()
            self.vec.copy_(self.host[i], non_blocking=True)
            self.runner.replay()
            need = int(self.runner.out.num_rendered)
            self.recaptures += 1
        if keep:
            self.kept[i] = self.runner.out.color.clone()
        return i

    def pool_rows(self):
        """The loaded pool's rows as the frames read them (alive first,
        in stored order): the leaves and the SH coefficients."""
        pv = self.pv
        n = self.cfg["primitives"]
        if pv.ragged is not None:
            sh = torch.zeros((n, 16, 3), device=self.dev)
            start = 0
            for d, blk in enumerate(pv.ragged.blocks):
                sh[start:start + blk.shape[0], :(d + 1) ** 2] = blk
                start += blk.shape[0]
        else:
            sh = pv.features[:n]
        return dict(xyz=pv.xyz[:n], scaling=pv.scaling[:n],
                    rotation=pv.rotation[:n], opacity=pv.opacity[:n],
                    sh=sh, degrees=pv.degrees[:n])

    def close(self):
        self.runner = self.pv = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_model(cfg, seed: int, device, dtype=torch.float32):
    """The model the stored file or the seeded scene means, over the
    primitive count: leaves with `sh` (N, 16, 3), degrees and alive."""
    leaves, stored = model_inputs(cfg, seed, device)
    n = cfg["primitives"]
    if stored is not None:
        books, ids, xyz = stored
        deq = dequantise(books, ids, xyz, leaves["degrees"][:n])
    else:
        deq = {k: leaves[k][:n] for k in LEAVES}
    out = {k: deq[k].to(dtype) for k in LEAVES}
    out["sh"] = torch.cat([out["features_dc"], out["features_rest"]], 1)
    out["degrees"] = leaves["degrees"][:n]
    out["alive"] = leaves["alive"][:n]
    return out


def reference_frame(cfg, model, pose, device, dtype=torch.float32,
                    count_pairs=False):
    cam = view_of(cfg, pose, device, dtype)
    with torch.no_grad():
        p = raster.project(model["xyz"], model["sh"], model["scaling"],
                           model["rotation"], model["opacity"][:, 0],
                           model["degrees"], model["alive"], cam)
        bins = raster.bin_tiles(p, cam.width, cam.height)
        bg = torch.zeros(3, device=device, dtype=dtype)
        if count_pairs:
            img, pairs = raster.composite(p, bins, bg, cam.width, cam.height,
                                          count_pairs=True)
            return img, raster.counts(p, bins, pairs)
        return (raster.composite(p, bins, bg, cam.width, cam.height),
                raster.pad_share(bins))


def timed_window(viewer: View, seconds: float, keep=(), tracer=None,
                 traced_frames: int = 0):
    """Frames until `seconds` have passed; returns (window seconds, frames,
    each frame's latency in seconds, the window's start).  With an
    active tracer the first `traced_frames` frames are traced, each a
    named host span."""
    lat = []
    keep = set(keep)
    if viewer.dev.type == "cuda":
        torch.cuda.synchronize()
    traced = tracer is not None and tracer.enabled
    if traced:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        want = viewer.next_pose in keep and viewer.next_pose not in viewer.kept
        with (torch.profiler.record_function("splatbench.frame")
              if traced else nullcontext()):
            viewer.frame(keep=want)
        e = time.perf_counter()
        lat.append(e - s)
        if traced and len(lat) == traced_frames:
            tracer.stop()
            traced = False
        if e - t0 >= seconds:
            break
    if traced:
        tracer.stop()
    return e - t0, len(lat), lat, t0


def p95(values) -> float:
    """The 95th percentile, nearest rank, of every value."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def measure(cfg, traffic, seed: int, seconds: float, tracing: bool, device):
    """One run of a `view` cell: set-up, the window, then the reference
    frames of the kept poses and, when traced, the pair counts."""
    from splatbench import judge
    from splatbench.profiling import Tracer
    from splatbench.record import Outcome

    drv = View(cfg, traffic, seed, device)
    rng = np.random.default_rng([int(seed), 6])
    keep = sorted(rng.choice(traffic["check_from"], traffic["check_frames"],
                             replace=False).tolist())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(tracing, device)
    window_s, frames, lat, t0 = timed_window(
        drv, seconds, keep, tracer, traffic["trace_frames"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tracer.read()
    notes = [f"window: {frames} frames in {window_s:.3f} s, budget "
             f"{drv.budget}, recaptures {drv.recaptures}, median frame "
             f"{1e3 * sorted(lat)[len(lat) // 2]:.4f} ms"]
    kept = drv.kept
    rows = None
    if drv.stored is not None:
        rows = {k: v.clone() for k, v in drv.pool_rows().items()}
    poses = drv.poses
    drv.close()
    del drv
    missing = [i for i in keep if i not in kept]
    precision = full_precision()
    precision.__enter__()
    model = reference_model(cfg, seed, device)
    numbers = {}
    if rows is not None:
        numbers["pool_gap"] = judge.pool_mismatch(rows, model)
        del rows
    refs, pads = {}, []
    for i in keep:
        if i in kept:
            refs[i], pad = reference_frame(cfg, model, poses[i], device)
            pads.append(pad)
    notes.append(f"pad need over the slack pool of the kept frames: {pads}")
    if missing or not refs:
        numbers["frames_missing"] = float(len(missing) or len(keep))
    if refs:
        numbers.update(judge.frame_numbers(kept, refs))
    record = dict(kind="view", frames=frames, window_s=window_s,
                  width=cfg["width"], height=cfg["height"],
                  degree_counts=scene.degree_counts(cfg),
                  traced_frames=min(frames, traffic["trace_frames"]))
    if tracer.summary is not None:
        pick = rng.choice(record["traced_frames"], traffic["count_samples"],
                          replace=False).tolist()
        record["counts"] = [reference_frame(cfg, model, poses[i], device,
                                            count_pairs=True)[1]
                            for i in pick]
        notes.append(f"reference counts of poses {pick}: {record['counts']}")
    precision.__exit__(None, None, None)
    return Outcome(t0, {"render_fps": frames / window_s,
                        "frame_ms_p95": 1e3 * p95(lat)},
                   record, numbers, frames, 0, peak, notes, tracer.summary)
