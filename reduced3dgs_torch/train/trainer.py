"""Training step and loop (PyTorch).

Counterpart of reduced3dgs_tpu/train/trainer.py.

``train_step`` is one iteration of the reference hot loop: render ->
loss -> gradients (autograd through the tile renderer's K3 + K5/K6
backward) -> densification statistics -> Adam.  The host-side
``Trainer`` owns what happens between iterations exactly as the JAX
Trainer does: the random camera order and backgrounds (numpy's
default_rng(seed), drawn at the same points), the SH-degree schedule,
the densify / prune / opacity-reset cadence, the store_grads ordering of
backward -> surgery -> optimizer step, mercy culling by the redundancy
metric of its own training cameras, adaptive SH-band culling at the given
iterations, pool-capacity growth and the per-camera instance budget on the
{2^k, 3*2^(k-1)} ladder.

Loss:
  (1-lambda_dssim) L1 + lambda_dssim (1-SSIM)
  + lambda_alpha_regul * mean(|sigmoid(opacity)| over visible)
  + lambda_sh_sparsity * mean(|f_rest| over visible)

Fused steps (``Trainer.step_group``, the JAX package's ``lax.scan`` of k
steps in one launch): on the card one train step is captured as a
``torch.cuda.CUDAGraph`` on its own static buffers and replayed k times;
between replays only device-to-device copies of the next step's inputs
(camera, background, learning rate and Adam's bias corrections packed in
one vector, and the ground-truth image) go into those buffers.  On the
CPU the same fused step runs k times in a loop (``fused_step``), which
tier-1 holds to sequential ``Trainer.step`` bit for bit.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from reduced3dgs_torch.cameras import (
    CAMERA_VEC, camera_from_vector, camera_vector,
)
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.graphs import Captured, kernel_counters
from reduced3dgs_torch.models.gaussians import (
    GaussianParams, GaussianPool, one_up_sh_degree, reset_opacity,
    round_capacity,
)
from reduced3dgs_torch.ops.losses import abs_jax, l1_loss, ssim
from reduced3dgs_torch.ops.preprocess import CameraParams
from reduced3dgs_torch.ops.redundancy import camera_stack, redundancy_metric
from reduced3dgs_torch.renderer import fit, next_budget, render
from reduced3dgs_torch.train import adam, densify
from reduced3dgs_torch.train.adam import AdamState
from reduced3dgs_torch.train.densify import WholeRows
from reduced3dgs_torch.utils import profiling

# A fused step's input vector: the camera (cameras.camera_vector), the
# background 3, then the 13 Adam scalars of Trainer._adam_scalars.
VEC_BG = slice(CAMERA_VEC, CAMERA_VEC + 3)
VEC_ADAM = 40
STEP_VEC = 53
FLOAT_METRICS = ("loss", "l1", "ssim_loss", "alpha_regul",
                 "sh_sparsity_loss")
INT_METRICS = ("num_rendered", "num_alive")
_STAT_LEAVES = ("max_radii2d", "xyz_grad_accum", "denom")
GRAPH_CACHE = 4  # captured step graphs a Trainer keeps
SH_DEGREE_INTERVAL = 1000  # iterations between two SH degree steps
FINE_TUNE_ITERS = 3000  # the last iterations of a compression run: no mercy
# the surgeries Trainer.events counts (SH-band culls last)
EVENTS = ("densify", "reset", "prune_dead", "mercy", "cull")
GRAPH_WARMUP = 2  # eager steps on the side stream before a capture


class TrainState(NamedTuple):
    pool: GaussianPool
    opt: AdamState
    generator: torch.Generator  # split noise, on the pool's device


def make_lr_tree(opt_cfg: OptimizationParams, xyz_lr: float):
    """Per-leaf learning rates (the reference's six parameter groups)."""
    return GaussianParams(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
    )


def _xyz_lr(iteration, opt_cfg: OptimizationParams, spatial_lr_scale):
    return adam.expon_lr(
        iteration,
        opt_cfg.position_lr_init * spatial_lr_scale,
        opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )


def train_step(state: TrainState, cam: CameraParams, gt_image, background,
               iteration: int, *, width, height, budget, backend,
               opt_cfg: OptimizationParams, spatial_lr_scale: float,
               skip_update: bool = False, grad_reduce: str = "f32",
               adam_scalars=None):
    """One training iteration.  Returns (state, metrics) — and the
    gradients (a GaussianParams) when skip_update, for the host to replay
    the reference ordering backward -> surgery -> step.  metrics hold
    0-dim tensors on the device.  adam_scalars: (xyz learning rate,
    per-leaf (c1, c2) bias corrections) as 0-dim float32 tensors in place
    of the values `iteration` and the state's step counts give (see
    fused_step).  Marks the boundaries of profiling.TRAIN_STAGES up to
    "store"; the caller ends the step (profiling.END) once it has stored
    the new state."""
    pool, opt, gen = state
    profiling.stage("preprocess", pool.device)
    leaves = [p.detach().requires_grad_(True) for p in pool.params]
    params = GaussianParams(*leaves)
    screen_offset = torch.zeros((pool.capacity, 2), dtype=torch.float32,
                                device=pool.device, requires_grad=True)
    out = render(
        params.xyz, torch.cat([params.features_dc, params.features_rest],
                              dim=1),
        params.scaling, params.rotation, params.opacity[:, 0], pool.degrees,
        cam, background, width=width, height=height, instance_budget=budget,
        alive_mask=pool.alive, backend=backend, grad_reduce=grad_reduce,
        screen_offset=screen_offset)
    profiling.stage("loss", pool.device)
    ll1 = l1_loss(out.color, gt_image)
    lssim = 1.0 - ssim(out.color, gt_image)
    vis = out.visibility
    nvis = torch.clamp(vis.sum(), min=1)
    loss = (1.0 - opt_cfg.lambda_dssim) * ll1 + opt_cfg.lambda_dssim * lssim
    zero = torch.zeros((), dtype=torch.float32, device=pool.device)
    lalpha = lsh = zero
    if opt_cfg.lambda_alpha_regul > 0:
        op = torch.sigmoid(params.opacity[:, 0])
        lalpha = torch.where(vis, abs_jax(op), 0.0).sum() / nvis
        loss = loss + opt_cfg.lambda_alpha_regul * lalpha
    if opt_cfg.lambda_sh_sparsity > 0:
        lsh = torch.where(vis[:, None, None], abs_jax(params.features_rest),
                          0.0).sum() / (nvis * 45)
        loss = loss + opt_cfg.lambda_sh_sparsity * lsh
    profiling.stage("loss_bwd", pool.device)
    got = torch.autograd.grad(loss, leaves + [screen_offset],
                              allow_unused=True)
    profiling.stage("adam", pool.device)
    grads = GaussianParams(*(torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, got[:-1])))
    g_screen = got[-1]

    with torch.no_grad():
        # densification statistics: viewspace gradients in NDC units
        gx = g_screen[:, 0] * (0.5 * width)
        gy = g_screen[:, 1] * (0.5 * height)
        gnorm = torch.sqrt(gx * gx + gy * gy)
        pool = pool.replace(
            xyz_grad_accum=pool.xyz_grad_accum + torch.where(vis, gnorm, 0.0),
            denom=pool.denom + vis.to(torch.float32),
            max_radii2d=torch.where(
                vis, torch.maximum(pool.max_radii2d,
                                   out.radii.to(torch.float32)),
                pool.max_radii2d))
        if skip_update:
            new_params, new_opt = pool.params, opt
        else:
            if adam_scalars is None:
                lr_xyz, bias = _xyz_lr(iteration, opt_cfg,
                                       spatial_lr_scale), None
            else:
                lr_xyz, bias = adam_scalars
            new_params, new_opt = adam.update(
                pool.params, grads, opt, make_lr_tree(opt_cfg, lr_xyz),
                bias=bias)
    profiling.stage("store", pool.device)
    pool = pool.replace(params=new_params)
    metrics = {
        "loss": loss.detach(), "l1": ll1.detach(),
        "ssim_loss": lssim.detach(), "alpha_regul": lalpha.detach(),
        "sh_sparsity_loss": lsh.detach(), "num_rendered": out.num_rendered,
        "num_alive": pool.num_alive,
    }
    state = TrainState(pool, new_opt, gen)
    if skip_update:
        return state, metrics, grads
    return state, metrics


def adam_scalars(t):
    """train_step's adam_scalars from the 13 values of
    Trainer._adam_scalars (a float32 tensor, views of it)."""
    n = len(GaussianParams._fields)
    return t[0], GaussianParams(*((t[1 + i], t[1 + n + i])
                                  for i in range(n)))


def carried(state: TrainState):
    """The tensors a train step hands to the next one: the six parameter
    leaves, Adam's moments and the three densification statistics."""
    pool, opt = state.pool, state.opt
    return (*pool.params, *opt.mu, *opt.nu,
            *(getattr(pool, k) for k in _STAT_LEAVES))


class FusedBuffers:
    """The static tensors a fused step reads and writes in place: what
    carried() lists, the degrees and alive mask, the step vector, the
    ground-truth image and the metrics of the last step (`metrics`: the
    names of the float and of the int32 ones, the budget's demand first
    among the latter)."""

    def __init__(self, state: TrainState, width: int, height: int,
                 metrics=(FLOAT_METRICS, INT_METRICS)):
        pool = state.pool
        dev = pool.device
        self.carried = tuple(torch.empty_like(t) for t in carried(state))
        self.degrees = torch.empty_like(pool.degrees)
        self.alive = torch.empty_like(pool.alive)
        self.vec = torch.zeros(STEP_VEC, dtype=torch.float32, device=dev)
        self.gt = torch.zeros((height, width, 3), dtype=torch.float32,
                              device=dev)
        self.float_names, self.int_names = metrics
        self.out_f = torch.zeros(len(self.float_names), dtype=torch.float32,
                                 device=dev)
        self.out_i = torch.zeros(len(self.int_names), dtype=torch.int32,
                                 device=dev)

    @torch.no_grad()
    def load(self, state: TrainState):
        pool = state.pool
        for dst, src in zip(self.carried + (self.degrees, self.alive),
                            carried(state) + (pool.degrees, pool.alive)):
            dst.copy_(src)

    @torch.no_grad()
    def store(self, state: TrainState, metrics: dict):
        """A step's new state and metrics written into the buffers."""
        for dst, src in zip(self.carried, carried(state)):
            dst.copy_(src)
        self.out_f.copy_(torch.stack([metrics[k].to(torch.float32)
                                      for k in self.float_names]))
        self.out_i.copy_(torch.stack([metrics[k].to(torch.int32)
                                      for k in self.int_names]))

    def state(self, active_sh_degree: int) -> TrainState:
        """The buffers as a TrainState (views, no copy; step counts 0)."""
        n = len(GaussianParams._fields)
        c = self.carried
        pool = GaussianPool(
            params=GaussianParams(*c[:n]), degrees=self.degrees,
            alive=self.alive, active_sh_degree=active_sh_degree,
            **dict(zip(_STAT_LEAVES, c[3 * n:])))
        opt = AdamState(mu=GaussianParams(*c[n:2 * n]),
                        nu=GaussianParams(*c[2 * n:3 * n]),
                        step=GaussianParams(*(0,) * n))
        return TrainState(pool, opt, None)

    def advanced(self, state: TrainState, k: int) -> TrainState:
        """`state` after k fused steps: copies of the buffers' carried
        tensors, the step counts advanced by k."""
        new = self.state(state.pool.active_sh_degree)
        clone = GaussianParams(*(t.clone() for t in new.pool.params))
        pool = state.pool.replace(params=clone, **{
            s: getattr(new.pool, s).clone() for s in _STAT_LEAVES})
        opt = AdamState(
            mu=GaussianParams(*(t.clone() for t in new.opt.mu)),
            nu=GaussianParams(*(t.clone() for t in new.opt.nu)),
            step=GaussianParams(*(t + k for t in state.opt.step)))
        return TrainState(pool, opt, state.generator)


def fused_step(buf: FusedBuffers, *, width, height, budget, backend,
               opt_cfg: OptimizationParams, grad_reduce: str,
               active_sh_degree: int):
    """One non-surgery train step on `buf`: reads the state, the step
    vector and the ground truth there and writes the new state and the
    metrics back in place.  The step a CUDA graph captures; every input
    that changes between steps is a tensor of `buf`, so a replay needs no
    host value."""
    state, metrics = train_step(
        buf.state(active_sh_degree),
        camera_from_vector(buf.vec, width, height), buf.gt,
        buf.vec[VEC_BG], 0, width=width, height=height, budget=budget,
        backend=backend, opt_cfg=opt_cfg, spatial_lr_scale=0.0,
        grad_reduce=grad_reduce,
        adam_scalars=adam_scalars(buf.vec[VEC_ADAM:]))
    buf.store(state, metrics)
    profiling.stage(profiling.END, buf.vec.device)


class StepLoop:
    """The plain version of a step graph (the CPU's): replay() runs
    `step` (fused_step, or another step of the same form with its
    `metrics`) on the buffers."""

    launches: dict = {}
    capture_s = 0.0

    def __init__(self, state: TrainState, step_kw: dict, step=fused_step,
                 metrics=(FLOAT_METRICS, INT_METRICS)):
        self.buf = FusedBuffers(state, step_kw["width"], step_kw["height"],
                                metrics)
        self.step = step
        self.step_kw = step_kw

    def replay(self):
        self.step(self.buf, **self.step_kw)


class StepGraph:
    """`step` (fused_step by default) captured once as a CUDA graph on its
    own buffers (graphs.Captured): GRAPH_WARMUP eager steps run first on
    a side stream, from `state` with the step vector `vec` and the ground
    truth `gt`.  ``launches`` holds each kernel's launches in one replay
    and ``capture_s`` the seconds of warm-up and capture."""

    def __init__(self, state: TrainState, vec, gt, step_kw: dict,
                 step=fused_step, metrics=(FLOAT_METRICS, INT_METRICS)):
        t0 = time.perf_counter()
        self.buf = buf = FusedBuffers(state, step_kw["width"],
                                      step_kw["height"], metrics)
        self.step_kw = step_kw

        def warm():
            buf.load(state)
            buf.vec.copy_(vec)
            buf.gt.copy_(gt)
            step(buf, **step_kw)

        graph = Captured(lambda: step(buf, **step_kw), warm,
                         buf.vec.device, GRAPH_WARMUP)
        self.replay = graph.replay
        self.launches = graph.launches
        self.capture_s = time.perf_counter() - t0


def train_steps_fused(runner, state: TrainState, vecs, gts):
    """k train steps in a row through one fused-step runner (a StepGraph
    on the card, a StepLoop on the CPU): the counterpart of the JAX
    package's lax.scan launch.  vecs: (k, STEP_VEC) float32 on the
    device, gts: k ground-truth images there.  Loads `state` into the
    runner's buffers (the state itself is not written), then per step
    copies the inputs in, replays, and copies the metrics out; no host
    read.  Returns the (k, n_float) float32 and (k, n_int) int32 metric
    rows (the buffers' float_names, int_names); the new state stays in
    runner.buf."""
    buf = runner.buf
    k = vecs.shape[0]
    dev = buf.vec.device
    hist_f = torch.empty((k,) + buf.out_f.shape, dtype=torch.float32,
                         device=dev)
    hist_i = torch.empty((k,) + buf.out_i.shape, dtype=torch.int32,
                         device=dev)
    buf.load(state)
    for j in range(k):
        buf.vec.copy_(vecs[j])
        buf.gt.copy_(gts[j])
        runner.replay()
        hist_f[j].copy_(buf.out_f)
        hist_i[j].copy_(buf.out_i)
    return hist_f, hist_i


@torch.no_grad()
def apply_update_step(state: TrainState, grads, iteration: int, *,
                      opt_cfg: OptimizationParams, spatial_lr_scale: float,
                      skip_opacity: bool = False):
    """The deferred optimizer step of a store_grads surgery iteration;
    skip_opacity replays reset_opacity (the new opacity tensor has no
    .grad, so torch skips exactly that parameter)."""
    pool, opt, gen = state
    lr_tree = make_lr_tree(opt_cfg,
                           _xyz_lr(iteration, opt_cfg, spatial_lr_scale))
    skip_tree = None
    if skip_opacity:
        skip_tree = GaussianParams(*(name == "opacity"
                                     for name in GaussianParams._fields))
    new_params, new_opt = adam.update(pool.params, grads, opt, lr_tree,
                                      skip_tree=skip_tree)
    return TrainState(pool.replace(params=new_params), new_opt, gen)


@torch.no_grad()
def densify_step(state: TrainState, extent, grads=None, *,
                 opt_cfg: OptimizationParams, use_size_threshold: bool,
                 with_grads: bool = False, normals=None, rows=densify.WHOLE):
    """densify_and_prune; with_grads threads the pending gradients through
    the surgery (new rows zero, pruned rows dropped).  rows: the state's
    row layout (densify.WholeRows, parallel/sharded.py:ShardRows)."""
    pool, opt, gen = state
    max_screen = 20.0 if use_size_threshold else 0.0
    pool, opt, grads, stats = densify.densify_and_prune(
        pool, opt, opt_cfg.densify_grad_threshold, 0.005, extent,
        max_screen, opt_cfg.percent_dense,
        grads_tree=grads if with_grads else None, normals=normals,
        generator=gen, rows=rows)
    if with_grads:
        return TrainState(pool, opt, gen), stats, grads
    return TrainState(pool, opt, gen), stats


@torch.no_grad()
def mercy_step(state: TrainState, splat_counts, *, lambda_mercy,
               mercy_minimum, mercy_type, uniform=None, rows=densify.WHOLE):
    """mercy_points on the redundancy metric's per-primitive values (the
    whole capacity's, mercy_counts); the coin flips of
    "redundancy_random" come from the state's generator (or `uniform`,
    see densify.mercy_points).  The stage mercy_select (utils/profiling.py)
    and the device counter mercy_pruned, the rows it removes."""
    pool, opt, gen = state
    with profiling.part("mercy_select", pool.device):
        pool, opt, stats = densify.mercy_points(
            pool, opt, splat_counts, lambda_mercy=lambda_mercy,
            mercy_minimum=mercy_minimum, mercy_type=mercy_type,
            generator=gen, uniform=uniform, rows=rows)
        profiling.count("mercy_pruned",
                        stats["n_points_mercied"].to(torch.int32))
    return TrainState(pool, opt, gen), stats


@torch.no_grad()
def mercy_counts(state: TrainState, cameras, *, pixel_scale,
                 rows=densify.WHOLE):
    """The redundancy metric of the whole pool over `cameras`' training
    cameras (a Trainer's or a dataset Scene's calculate_redundancy_metric)
    on the whole columns it reads: xyz, activated scale, normalised
    rotation and alive (41 B a row; on a row shard gathered, and every
    tile member computes the whole (C,) result)."""
    pool = state.pool
    cols = tuple(rows.column(x) for x in (
        pool.params.xyz, pool.get_scaling(), pool.get_rotation(),
        pool.alive))
    return cameras.calculate_redundancy_metric(pixel_scale=pixel_scale,
                                               columns=cols)[0]


@torch.no_grad()
def prune_dead_step(state: TrainState, extent, rows=densify.WHOLE):
    """prune(1/255) of dead points."""
    pool, opt, gen = state
    pool, opt, n = densify.prune(pool, opt, 1.0 / 255.0, extent, 0.0, rows)
    return TrainState(pool, opt, gen), n


@torch.no_grad()
def opacity_reset_step(state: TrainState):
    """reset_opacity + zeroed opacity Adam moments."""
    pool, opt, gen = state
    opt = opt._replace(
        mu=opt.mu._replace(opacity=torch.zeros_like(opt.mu.opacity)),
        nu=opt.nu._replace(opacity=torch.zeros_like(opt.nu.opacity)))
    return TrainState(reset_opacity(pool), opt, gen)


class Trainer:
    """Host-side loop controller (the reference's training())."""

    def __init__(self, pool: GaussianPool, opt_cfg: OptimizationParams,
                 cameras, *, spatial_lr_scale: float, background,
                 backend: str = "tile", max_sh_degree: int = 3,
                 seed: int = 0, initial_budget: int = 1 << 17,
                 cull_sh_iterations=(), white_background: bool = False,
                 grad_reduce: str = "f32"):
        self.opt_cfg = opt_cfg
        self.white_background = white_background
        self.cameras = list(cameras)
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.device = pool.device
        self.background = torch.as_tensor(background, dtype=torch.float32,
                                          device=self.device)
        self._background_host = self.background.cpu().numpy()
        self.backend = backend
        self.grad_reduce = grad_reduce
        self.max_sh_degree = max_sh_degree
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = TrainState(pool, adam.init(pool.params), gen)
        self.rng = np.random.default_rng(seed)
        self.initial_budget = initial_budget
        self.cull_sh_iterations = tuple(cull_sh_iterations)
        self._cameras_stacked = None  # the redundancy metric's, made once
        # the state's row layout, which the surgery's events run on
        self.rows = WholeRows()
        # start of the compression fine-tune phase: no mercy after it
        self.fine_tune_start = opt_cfg.iterations
        if self.cull_sh_iterations or opt_cfg.mercy_points:
            self.fine_tune_start = opt_cfg.iterations - FINE_TUNE_ITERS
        self._stack: list[int] = []
        self.budgets: dict[int, int] = {}  # camera uid -> instance budget
        self._gt: dict[int, torch.Tensor] = {}  # camera uid -> GT image
        self.extent = None  # set by the caller (scene cameras_extent)
        self.stats = {}
        # how often each surgery ran, and the iterations step_group ran
        self.events = dict.fromkeys(EVENTS, 0)
        self.grouped_steps = 0
        self.iteration = 0
        # step_group on the card: captured step graphs (least recently
        # used first), and what their replays and captures amounted to
        self._graphs: OrderedDict = OrderedDict()
        self.graph_launches = {n: 0 for n in kernel_counters()}
        self.graph_captures = 0
        self.capture_s = 0.0

    # -- camera sampling: shuffle without replacement --------------------
    def _next_camera_idx(self):
        if not self._stack:
            self._stack = list(self.rng.permutation(len(self.cameras)))
        return self._stack.pop()

    def next_camera(self):
        return self.cameras[self._next_camera_idx()]

    def calculate_redundancy_metric(self, pixel_scale=1.0,
                                    num_neighbours=30, columns=None):
        """(min_redundancy (C,) int32, cube_size (C,)) of the state's pool
        over the training cameras, as Scene.calculate_redundancy_metric
        computes it (ops/redundancy.py): the cameras' projections and
        sizes stacked on the device once.  columns: the (xyz, activated
        scales, normalised rotations, alive) to read in place of the
        pool's (a sharded trainer's gathered ones).  Mercy reads it."""
        if columns is None:
            pool = self.state.pool
            columns = (pool.params.xyz, pool.get_scaling(),
                       pool.get_rotation(), pool.alive)
        if self._cameras_stacked is None:
            self._cameras_stacked = camera_stack(self.cameras, self.device)
        return redundancy_metric(*columns, *self._cameras_stacked,
                                 pixel_scale=pixel_scale,
                                 num_neighbours=num_neighbours)

    def gt_image(self, camera):
        """The camera's ground truth as a device tensor (cached)."""
        img = self._gt.get(camera.uid)
        if img is None:
            img = torch.as_tensor(np.asarray(camera.image, np.float32),
                                  device=self.device)
            self._gt[camera.uid] = img
        return img

    def _events(self, iteration):
        """The reference's densification-cadence booleans (densify, reset,
        prune dead, mercy) for one iteration."""
        cfg = self.opt_cfg
        will_densify = (iteration < cfg.densify_until_iter
                        and iteration > cfg.densify_from_iter
                        and iteration % cfg.densification_interval == 0)
        will_reset = (iteration < cfg.densify_until_iter
                      and (iteration % cfg.opacity_reset_interval == 0
                           or (self.white_background
                               and iteration == cfg.densify_from_iter)))
        will_prune_dead = (iteration >= cfg.densify_until_iter
                           and cfg.prune_dead_points
                           and iteration % cfg.densification_interval == 0)
        will_mercy = (cfg.mercy_points
                      and iteration % (cfg.mercy_interval
                                       * cfg.densification_interval) == 0
                      and iteration <= self.fine_tune_start
                      and (iteration >= cfg.densify_until_iter
                           or iteration % cfg.opacity_reset_interval != 0))
        return will_densify, will_reset, will_prune_dead, will_mercy

    def events_at(self, iteration):
        """The names (of EVENTS) of the surgeries step(iteration) runs, in
        the order it runs them: "cull" where the iteration is listed in
        cull_sh_iterations."""
        ran = self._events(iteration) + (
            iteration in self.cull_sh_iterations,)
        return tuple(n for n, r in zip(EVENTS, ran) if r)

    def fusible(self, iteration):
        """True when `iteration` has no host boundary of the trainer (SH
        degree step, cull, densify / reset / prune / mercy, the final
        iteration): such iterations may run in a step_group with the
        results of sequential step() calls."""
        if (iteration % SH_DEGREE_INTERVAL == 0
                or iteration in self.cull_sh_iterations):
            return False
        if iteration >= self.opt_cfg.iterations:  # final never steps
            return False
        return not any(self._events(iteration))

    def step_group(self, iterations):
        """Run consecutive fusible iterations as one group
        (train_steps_fused: a replayed CUDA graph on the card, a loop on
        the CPU).  Returns a list of per-iteration metrics dicts (device
        tensors).  Semantics of sequential step(): the cameras are popped
        and the random backgrounds drawn in step()'s order, and only a
        same-resolution prefix runs (a resolution change un-pops the
        camera and ends the group); one budget for the group, the largest
        of its cameras'; one host read of num_rendered after the group,
        and on overflow the cameras' budgets grow on the ladder and the
        whole group runs again from the same state with the same cameras
        and backgrounds.

        Its host time is tiled by the spans r3dgs.step_group.<part>:
        prepare (cameras, backgrounds, the step vectors and their copy to
        the device), replays, read (the host read of num_rendered, which
        waits for the card) and unpack (the new state and the metric
        dicts)."""
        with profiling.span("r3dgs.step_group"):
            return self._step_group(list(iterations))

    def _step_group(self, iterations):
        cfg = self.opt_cfg
        if not iterations or not all(self.fusible(i) for i in iterations):
            raise ValueError(f"step_group: iterations {iterations} are not "
                             f"all fusible")
        with profiling.span("r3dgs.step_group.prepare"):
            cams, bgs = [], []
            for _ in iterations:
                i = self._next_camera_idx()
                c = self.cameras[i]
                if cams and (c.width, c.height) != (cams[0].width,
                                                    cams[0].height):
                    self._stack.append(i)
                    break
                cams.append(c)
                bgs.append(self.rng.uniform(0.0, 1.0, 3)
                           if cfg.random_background else self._background_host)
            k = len(cams)
            iterations = iterations[:k]
            self.iteration = iterations[-1]
            vecs = torch.as_tensor(np.stack([
                np.concatenate([camera_vector(c), np.asarray(bg, np.float32),
                                self._adam_scalars(it, j)])
                for j, (c, bg, it) in enumerate(zip(cams, bgs, iterations))]),
                device=self.device)
            gts = [self.gt_image(c) for c in cams]
        while True:
            with profiling.span("r3dgs.step_group.replays"):
                budget = max(self._budget_for(c.uid) for c in cams)
                runner = self._runner(cams[0].width, cams[0].height, budget,
                                      vecs[0], gts[0])
                hist_f, hist_i = train_steps_fused(runner, self.state, vecs,
                                                   gts)
                for n, v in runner.launches.items():
                    self.graph_launches[n] += v * k
            with profiling.span("r3dgs.step_group.read"):
                needed = hist_i[:, 0].cpu().numpy()
            if int(needed.max()) <= budget:
                break
            # not renderer.fit: each camera climbs by its own need
            profiling.add("budget_redos")
            for c, n in zip(cams, needed):
                self._budget_for(c.uid, int(n))
        with profiling.span("r3dgs.step_group.unpack"):
            buf = runner.buf
            self.state = buf.advanced(self.state, k)
            self.grouped_steps += k
            out = []
            for j in range(k):
                m = {n: hist_f[j, i] for i, n in enumerate(buf.float_names)}
                m.update({n: hist_i[j, i]
                          for i, n in enumerate(buf.int_names)})
                out.append(m)
        return out

    def _adam_scalars(self, iteration, ahead=0):
        """The xyz learning rate of `iteration` and Adam's bias
        corrections c1 (six leaves), then c2, for each leaf's step count
        plus `ahead` plus one: float32 (13,), the tail of a step vector."""
        bias = [adam.corrections(t + ahead + 1)
                for t in self.state.opt.step]
        return np.float32([_xyz_lr(iteration, self.opt_cfg,
                                   self.spatial_lr_scale)]
                          + [b[0] for b in bias] + [b[1] for b in bias])

    def _fused_step(self):
        """What a group replays: the step function, its keywords beyond
        the group's shapes and schedule, and its metric names."""
        return fused_step, dict(backend=self.backend), (FLOAT_METRICS,
                                                        INT_METRICS)

    def _runner(self, width, height, budget, vec, gt):
        """The fused-step runner of this group's shapes: a StepLoop on the
        CPU; on the card the cached StepGraph of the key, or a new
        capture (at most GRAPH_CACHE are kept, the least recently used
        goes first)."""
        pool = self.state.pool
        step, kw, metrics = self._fused_step()
        step_kw = dict(width=width, height=height, budget=budget,
                       opt_cfg=self.opt_cfg, grad_reduce=self.grad_reduce,
                       active_sh_degree=int(pool.active_sh_degree), **kw)
        if self.device.type != "cuda":
            return StepLoop(self.state, step_kw, step, metrics)
        key = (width, height, budget, pool.capacity,
               step_kw["active_sh_degree"], self.grad_reduce, self.opt_cfg,
               step, *kw.items())
        graph = self._graphs.pop(key, None)
        if graph is None:
            while len(self._graphs) >= GRAPH_CACHE:
                self._graphs.popitem(last=False)
            graph = StepGraph(self.state, vec, gt, step_kw, step, metrics)
            self.graph_captures += 1
            self.capture_s += graph.capture_s
        self._graphs[key] = graph
        return graph

    def _budget_for(self, cam_uid, needed=None):
        """The camera's budget, first climbed up renderer.next_budget's
        ladder to cover `needed`."""
        b = next_budget(self.budgets.get(cam_uid, self.initial_budget),
                        needed or 0)
        self.budgets[cam_uid] = b
        return b

    def maybe_grow_pool(self, pending=None):
        """Double the capacity (a power-of-two bucket) when more than 90 %
        of the slots are alive; returns the pending gradients, grown with
        the state."""
        pool, opt, gen = self.state
        n = int(self.rows.total(pool.alive))
        cap = self.rows.capacity(pool)
        if n > 0.9 * cap:
            pool, opt, pending = self.rows.grow(pool, opt, pending,
                                                round_capacity(cap * 2))
            self.state = TrainState(pool, opt, gen)
        return pending

    def step(self, iteration: int):
        """One training iteration; returns the metrics dict (device
        tensors — only sync what you read).

        Ordering as the reference: backward -> densify/prune/mercy
        surgery -> optimizer step.  On a surgery iteration the step
        applies only to the parameters that kept a .grad through it: all
        of them with store_grads on a densify iteration, none on a mercy
        or dead-prune iteration or a densify iteration without
        store_grads, everything except opacity on a reset-only iteration.
        The final iteration never steps.  An iteration listed in
        cull_sh_iterations ends with the SH-band cull (two transmittance
        renders per training camera).  Host span r3dgs.step, and
        r3dgs.surgery.<event> for each surgery event.
        """
        with profiling.span("r3dgs.step"):
            return self._step(iteration)

    def _step(self, iteration: int):
        cfg = self.opt_cfg
        self.iteration = iteration
        if iteration % SH_DEGREE_INTERVAL == 0:
            self.state = self.state._replace(pool=one_up_sh_degree(
                self.state.pool, self.max_sh_degree))
        will_densify, will_reset, will_prune_dead, will_mercy = (
            self._events(iteration))
        surgery = will_densify or will_reset or will_prune_dead or will_mercy
        final = iteration >= cfg.iterations

        camera = self.next_camera()
        cp = camera.params(self.device)
        gt = self.gt_image(camera)
        scalars = None
        if not (surgery or final):
            # the update's scalars as tensors on the device, as a fused
            # step (a replayed graph) reads them: the same arithmetic
            scalars = adam_scalars(torch.as_tensor(
                self._adam_scalars(iteration), device=self.device))
        background = self.background
        if cfg.random_background:
            background = torch.as_tensor(self.rng.uniform(0.0, 1.0, 3),
                                         dtype=torch.float32,
                                         device=self.device)

        def attempt(budget):
            # a redo is this step exactly: same camera, same background
            out = train_step(
                self.state, cp, gt, background, iteration,
                width=camera.width, height=camera.height, budget=budget,
                backend=self.backend, opt_cfg=cfg,
                spatial_lr_scale=self.spatial_lr_scale,
                skip_update=surgery or final, grad_reduce=self.grad_reduce,
                adam_scalars=scalars)
            profiling.stage(profiling.END, self.device)
            return out, int(out[1]["num_rendered"])

        out, budget = fit(attempt, self._budget_for(camera.uid))
        self._budget_for(camera.uid, budget)
        self.state = out[0]
        self._surgery(iteration, out[2] if len(out) == 3 else None, final)
        return out[1]

    def _surgery(self, iteration: int, pending, final: bool):
        """What step() does after the backward: the densify / reset /
        prune / mercy surgery of `iteration`'s events, the deferred
        optimizer step with the `pending` gradients (None: none), and the
        SH-band cull of a listed iteration.  Every event runs on the
        state's row layout `self.rows` (the whole pool here, a row shard
        in parallel/sharded.py:ShardedTrainer)."""
        cfg = self.opt_cfg
        rows = self.rows
        will_densify, will_reset, will_prune_dead, will_mercy = (
            self._events(iteration))
        for name in self.events_at(iteration):
            self.events[name] += 1
        if will_densify:
            with profiling.span("r3dgs.surgery.densify"):
                pending = self.maybe_grow_pool(pending)
                use_size = iteration > cfg.opacity_reset_interval
                if cfg.store_grads and pending is not None:
                    self.state, dstats, pending = densify_step(
                        self.state, float(self.extent), pending, opt_cfg=cfg,
                        use_size_threshold=use_size, with_grads=True,
                        rows=rows)
                else:
                    self.state, dstats = densify_step(
                        self.state, float(self.extent), opt_cfg=cfg,
                        use_size_threshold=use_size, rows=rows)
                    pending = None  # params rebuilt without store_grads
                self.stats.update({k: int(v) for k, v in dstats.items()})
        if will_reset:
            with profiling.span("r3dgs.surgery.reset"):
                self.state = opacity_reset_step(self.state)
        if will_prune_dead:
            with profiling.span("r3dgs.surgery.prune_dead"):
                self.state, n = prune_dead_step(self.state,
                                                float(self.extent), rows)
                self.stats["n_points_pruned"] = int(n)
            pending = None  # prune() is called without store_grads

        if will_mercy:
            with profiling.span("r3dgs.surgery.mercy"):
                red = mercy_counts(self.state, self,
                                   pixel_scale=cfg.box_size, rows=rows)
                self.state, mstats = mercy_step(
                    self.state, red, lambda_mercy=cfg.lambda_mercy,
                    mercy_minimum=cfg.mercy_minimum,
                    mercy_type=cfg.mercy_type, rows=rows)
                profiling.stage(profiling.END, self.device)
                self.stats["n_points_mercied"] = int(
                    mstats["n_points_mercied"])
                self.stats["redundancy_threshold"] = float(
                    mstats["redundancy_threshold"])
                self.stats["opacity_threshold"] = float(
                    mstats["opacity_threshold"])
            pending = None  # mercy_points prunes without store_grads

        if pending is not None and not final:
            self.state = apply_update_step(
                self.state, pending, iteration, opt_cfg=cfg,
                spatial_lr_scale=self.spatial_lr_scale,
                skip_opacity=will_reset)

        if iteration in self.cull_sh_iterations:
            from reduced3dgs_torch.ops.sh_culling import cull_sh_bands

            # every render of the cull starts at one budget, the largest
            # any camera has needed so far; an overflowing render is redone
            # up the ladder by renderer.fit (sh_culling.render_transmittance;
            # a row shard's strips are not redone)
            with profiling.span("r3dgs.surgery.cull"):
                pool = cull_sh_bands(
                    self.state.pool, self.cameras,
                    threshold=cfg.cdist_threshold * math.sqrt(3) / 255.0,
                    std_threshold=cfg.std_threshold,
                    budget=max(self.budgets.values(),
                               default=self.initial_budget),
                    backend=self.backend, max_sh_degree=self.max_sh_degree,
                    active_sh_degree=int(self.state.pool.active_sh_degree),
                    transmittance=rows.transmittance)
            self.state = self.state._replace(pool=pool)
