"""The `train` traffic: a closed loop of training iterations of the
paper's `full_final` schedule through the program's Trainer.

Set-up builds one Trainer on the seeded scene (a state in mid-training:
SH degree 3, Adam moments, step counts at the window's first iteration),
puts every camera's ground truth on the device, settles every camera's
instance budget, and drives the trainer through its first iterations by
the window's own calls: `check_steps` iterations as step groups (which
captures the step graph), then one dead-prune iteration by `step()`.
Those are the readings the reference judges.  The window then cycles
through the traffic's iterations, one step group of every run of
fusible iterations and one `step()` for every surgery iteration, from
where set-up left off, and starts the cycle again with the state as it
stands.
"""

from __future__ import annotations

import gc
import json
import time
from contextlib import nullcontext

import numpy as np
import torch

from splatbench import scene
from splatbench.reference import full_precision, raster
from splatbench.reference import train as ref

LEAVES = scene.LEAVES


def optimization(cfg):
    from reduced3dgs_torch.config import OptimizationParams

    t = cfg["training"]
    keys = OptimizationParams.__dataclass_fields__
    return OptimizationParams(**{k: v for k, v in t.items() if k in keys})


def extent(poses) -> float:
    """The scene extent of the published method: 1.1 times the largest
    distance of a train camera from their mean centre."""
    eyes = np.stack([e for _, _, e in poses])
    return float(1.1 * np.linalg.norm(eyes - eyes.mean(0), axis=1).max())


def state_inputs(cfg, seed: int, device):
    """The scene's primitives and Adam moments (from the seed)."""
    from splatbench import quantised
    from splatbench.reference.dequant import dequantise

    leaves = scene.primitives(cfg, seed, device)
    if cfg.get("stored") == "quantised_half":
        # the reduced model trains on the dequantised values of its file
        n = cfg["primitives"]
        books, ids, xyz = quantised.quantise(leaves, n)
        deq = dequantise(books, ids, xyz, leaves["degrees"][:n])
        for k in LEAVES:
            leaves[k][:n] = deq[k]
    mu, nu = scene.moments(cfg, seed, leaves)
    return leaves, mu, nu


def camera_order(seed: int, count: int):
    """The training cameras in the order the published loop draws them:
    a seeded permutation, taken from its end."""
    return list(np.random.default_rng(seed).permutation(count))[::-1]


class Train:
    """One cell's trainer, its window and its readings."""

    def __init__(self, cfg, traffic, seed: int, device):
        from reduced3dgs_torch.cameras import Camera
        from reduced3dgs_torch.models.gaussians import (
            GaussianParams, GaussianPool,
        )
        from reduced3dgs_torch.renderer import render
        from reduced3dgs_torch.train.adam import AdamState
        from reduced3dgs_torch.train.trainer import Trainer, TrainState

        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, device
        leaves, mu, nu = state_inputs(cfg, seed, device)
        poses = scene.training_poses(cfg, seed)
        fov_x = np.radians(cfg["assumed"]["fov_x_deg"])
        fov_y = scene.fov_y(cfg)
        w, h = cfg["width"], cfg["height"]
        cams = [Camera(uid=i, colmap_id=i, R=R, T=T, fov_x=fov_x, fov_y=fov_y,
                       image=None, image_name=f"{i:05d}", width=w, height=h)
                for i, (R, T, _) in enumerate(poses)]
        self.extent = extent(poses)
        params = GaussianParams(*(leaves[k].clone() for k in LEAVES))
        pool = GaussianPool(params=params, degrees=leaves["degrees"].clone(),
                            alive=leaves["alive"].clone(),
                            active_sh_degree=cfg["sh_degree"])
        t = cfg["training"]
        tr = Trainer(pool, optimization(cfg), cams,
                     spatial_lr_scale=self.extent,
                     background=np.zeros(3, np.float32), seed=seed,
                     cull_sh_iterations=tuple(t.get("cull_SH", ())),
                     grad_reduce=cfg["grad_reduce"])
        tr.extent = self.extent
        steps = GaussianParams(*(traffic["first_iteration"] - 1
                                 for _ in LEAVES))
        tr.state = TrainState(
            pool, AdamState(mu=GaussianParams(*(mu[k].clone()
                                                for k in LEAVES)),
                            nu=GaussianParams(*(nu[k] for k in LEAVES)),
                            step=steps), tr.state.generator)
        for i, cam in enumerate(cams):
            tr._gt[cam.uid] = scene.ground_truth(cfg, seed, i, device)
        # every camera's instance count on the seeded state, and one budget
        # for all of them with the traffic's headroom (one step graph)
        bg = torch.zeros(3, device=device)
        need = 0
        with torch.inference_mode():
            for cam in cams:
                out = render(*self._render_args(pool), cam.params(device), bg,
                             width=w, height=h, instance_budget=1 << 16,
                             alive_mask=pool.alive)
                need = max(need, int(out.num_rendered))
        budget = tr._budget_for(cams[0].uid,
                                int(need * traffic["budget_headroom"]))
        for cam in cams:
            tr.budgets[cam.uid] = budget
        self.trainer = tr
        self.budget = budget
        self.mu0 = mu
        self.params0 = leaves
        del nu

    @staticmethod
    def _render_args(pool):
        p = pool.params
        return (p.xyz, torch.cat([p.features_dc, p.features_rest], 1),
                p.scaling, p.rotation, p.opacity[:, 0], pool.degrees)

    # -- the first iterations: the readings -------------------------------
    def check_steps(self):
        """The first `check_steps` iterations by the window's calls, and
        a dead-prune iteration by step(); returns the program's readings
        (losses, first gradients' and 3-step changes' norms per leaf, the
        alive masks around the prune)."""
        tr = self.trainer
        first = self.traffic["first_iteration"]
        n = self.traffic["check_steps"]
        m1 = tr.step_group([first])
        opt = tr.state.opt
        g_norm = {k: float(((getattr(opt.mu, k) - ref.B1 * self.mu0[k])
                            / (1 - ref.B1)).norm()) for k in LEAVES}
        ms = m1 + tr.step_group(list(range(first + 1, first + n)))
        params = tr.state.pool.params
        change = {k: float((getattr(params, k) - self.params0[k]).norm())
                  for k in LEAVES}
        losses = [float(m["loss"]) for m in ms]
        self.mu0 = self.params0 = None
        prune_it = self.traffic["surgery_every"] * (
            (first + n) // self.traffic["surgery_every"] + 1)
        pool = tr.state.pool
        alive_before = pool.alive.clone()
        opacity = pool.params.opacity[:, 0].clone()
        tr.step(prune_it)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        alive_after = tr.state.pool.alive.clone()
        self.next_iteration = prune_it + 1
        return dict(losses=losses, grad_norms=g_norm, change_norms=change,
                    prune=(alive_before, opacity, alive_after))

    # -- the window ---------------------------------------------------------
    def calls(self):
        """The window's calls, endlessly: ("group", iterations) for each
        run of fusible iterations, ("step", [iteration]) otherwise."""
        tr = self.trainer
        lo, hi = self.traffic["first_iteration"], self.traffic["last_iteration"]
        it = self.next_iteration
        while True:
            if it > hi:
                it = lo
            if tr.fusible(it):
                run = []
                while it <= hi and tr.fusible(it):
                    run.append(it)
                    it += 1
                yield "group", run
            else:
                yield "step", [it]
                it += 1

    def run_call(self, kind, its):
        tr = self.trainer
        if kind == "group":
            ms = tr.step_group(its)
        else:
            ms = [tr.step(its[0])]
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return ms

    @staticmethod
    def window_readings(first_call, last_call):
        """The drift over the window: the mean num_rendered of the first
        and of the last call's iterations (their cameras differ), and the
        alive count at the window's first and last iteration."""
        def mean(ms):
            return sum(int(m["num_rendered"]) for m in ms) / len(ms)

        return {"num_rendered_start": mean(first_call),
                "num_rendered_end": mean(last_call),
                "alive_start": int(first_call[0]["num_alive"]),
                "alive_end": int(last_call[-1]["num_alive"])}

    def close(self):
        self.trainer = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(cfg, traffic, seed: int, device, dtype=torch.float32,
                       rows=None):
    """The reference's readings of the same first iterations, from the
    same seeded inputs: the losses, the first gradient's norm per leaf
    and the change of each leaf after `check_steps` iterations, and each
    view's raster.pad_share.  dtype: a lower precision (the control);
    rows: the image loss over the first rows only (a planted fault)."""
    leaves, mu, nu = state_inputs(cfg, seed, device)
    poses = scene.training_poses(cfg, seed)
    ext = extent(poses)
    order = camera_order(seed, len(poses))
    degrees, alive = leaves["degrees"], leaves["alive"]
    params = {k: leaves[k].to(dtype) for k in LEAVES}
    start = {k: v.clone() for k, v in params.items()}
    mu = {k: v.to(dtype) for k, v in mu.items()}
    nu = {k: v.to(dtype) for k, v in nu.items()}
    first = traffic["first_iteration"]
    steps = {k: first - 1 for k in LEAVES}
    opt = cfg["training"]
    bg = torch.zeros(3, device=device, dtype=dtype)
    losses, g_norm, pads = [], None, []
    for j in range(traffic["check_steps"]):
        cam = view_of(cfg, poses[order[j]], device, dtype)
        gt = scene.ground_truth(cfg, seed, int(order[j]), device).to(dtype)
        loss, grads, pad = ref.loss_and_grads(params, degrees, alive, cam, gt,
                                              bg, opt, rows)
        losses.append(float(loss))
        pads.append(pad)
        if g_norm is None:
            g_norm = {k: float(grads[k].float().norm()) for k in LEAVES}
        lrs = ref.learning_rates(first + j, ext, opt)
        params, mu, nu, steps = ref.adam(params, grads, mu, nu, steps, lrs)
        del grads
    change = {k: float((params[k].float() - start[k].float()).norm())
              for k in LEAVES}
    return dict(losses=losses, grad_norms=g_norm, change_norms=change,
                pad_shares=pads)


def view_of(cfg, pose, device, dtype=torch.float32) -> raster.Camera:
    R, T, eye = pose
    fx = np.radians(cfg["assumed"]["fov_x_deg"])
    fy = scene.fov_y(cfg)
    v, p = scene.matrices(R, T, fx, fy)
    return raster.Camera(
        view=torch.as_tensor(v, device=device).to(dtype),
        proj=torch.as_tensor(p, device=device).to(dtype),
        centre=torch.as_tensor(np.asarray(eye, np.float32),
                               device=device).to(dtype),
        tan_x=float(np.tan(fx / 2)), tan_y=float(np.tan(fy / 2)),
        width=cfg["width"], height=cfg["height"])


def pair_counts(cfg, seed: int, device, pose_indices):
    """raster.counts of each listed train camera on the seeded state, by
    the reference."""
    leaves, _, _ = state_inputs(cfg, seed, device)
    poses = scene.training_poses(cfg, seed)
    sh = torch.cat([leaves["features_dc"], leaves["features_rest"]], 1)
    out = []
    with torch.no_grad():
        for i in pose_indices:
            cam = view_of(cfg, poses[i], device)
            p = raster.project(leaves["xyz"], sh, leaves["scaling"],
                               leaves["rotation"], leaves["opacity"][:, 0],
                               leaves["degrees"], leaves["alive"], cam)
            bins = raster.bin_tiles(p, cam.width, cam.height)
            _, pairs = raster.composite(
                p, bins, torch.zeros(3, device=device), cam.width,
                cam.height, count_pairs=True)
            out.append(raster.counts(p, bins, pairs))
    return out


def timed_window(run: Train, seconds: float, tracer=None,
                 traced_calls: int = 0):
    """Run the window's calls until `seconds` have passed; returns
    (window seconds, iterations, spans [(kind, start, end, iterations)],
    the first and the last call's metrics, the window's start).  With an
    active tracer
    the first `traced_calls` calls are traced, each a named host span."""
    spans = []
    done = 0
    first = last = None
    if run.dev.type == "cuda":
        torch.cuda.synchronize()
    traced = tracer is not None and tracer.enabled
    if traced:
        tracer.start()
    t0 = time.perf_counter()
    for kind, its in run.calls():
        s = time.perf_counter()
        with (torch.profiler.record_function(f"splatbench.{kind}")
              if traced else nullcontext()):
            ms = run.run_call(kind, its)
        e = time.perf_counter()
        spans.append((kind, s, e, len(its)))
        first = first or ms
        last = ms
        done += len(its)
        if traced and len(spans) == traced_calls:
            tracer.stop()
            traced = False
        if e - t0 >= seconds:
            break
    if traced:
        tracer.stop()
    return e - t0, done, spans, first, last, t0


def measure(cfg, traffic, seed: int, seconds: float, tracing: bool, device):
    """One run of a `train` cell: set-up, the check iterations, the
    window, then the reference and, when traced, the pair counts."""
    from splatbench import judge
    from splatbench.profiling import Tracer
    from splatbench.record import Outcome

    drv = Train(cfg, traffic, seed, device)
    prog = drv.check_steps()
    prune = prog.pop("prune")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(tracing, device)
    window_s, iters, spans, first, last, t0 = timed_window(
        drv, seconds, tracer, traffic["trace_calls"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tracer.read()
    notes = [f"window: {iters} iterations in {window_s:.3f} s, "
             f"{sum(1 for s in spans if s[0] == 'step')} surgery calls, "
             f"budget {drv.budget}"]
    notes += [f"{k} {v}" for k, v in Train.window_readings(first,
                                                           last).items()]
    numbers = {}
    numbers["prune_mismatches"] = judge.prune_mismatches(prune)
    del prune, first, last
    drv.close()
    del drv
    with full_precision():
        ref_read = reference_readings(cfg, traffic, seed, device)
    numbers.update(judge.train_numbers(prog, ref_read))
    notes.append("pad need over the slack pool of the check views: "
                 f"{ref_read.pop('pad_shares')}")
    notes.append(f"program {json_line(prog)}")
    notes.append(f"reference {json_line(ref_read)}")
    traced = sum(n for _, _, _, n in spans[:traffic["trace_calls"]])
    record = dict(kind="train", spans=spans, iterations=iters,
                  traced_iterations=traced, window_s=window_s,
                  width=cfg["width"],
                  height=cfg["height"],
                  degree_counts=scene.degree_counts(cfg))
    if tracer.summary is not None:
        rng = np.random.default_rng([int(seed), 5])
        pick = rng.choice(cfg["train_cameras"], traffic["count_samples"],
                          replace=False)
        with full_precision():
            record["counts"] = pair_counts(cfg, seed, device, pick.tolist())
        notes.append(f"reference counts of cameras {pick.tolist()}: "
                     f"{record['counts']}")
    return Outcome(t0, {"train_ms_per_iter": 1e3 * window_s / iters},
                   record, numbers, iters, 0, peak, notes, tracer.summary)


def json_line(d) -> str:
    return json.dumps(d, sort_keys=True)
