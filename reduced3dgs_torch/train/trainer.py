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
metric, adaptive SH-band culling at the given iterations, pool-capacity
growth and the per-camera instance budget on the {2^k, 3*2^(k-1)} ladder.

Loss:
  (1-lambda_dssim) L1 + lambda_dssim (1-SSIM)
  + lambda_alpha_regul * mean(|sigmoid(opacity)| over visible)
  + lambda_sh_sparsity * mean(|f_rest| over visible)

Not ported (they raise): fused steps (train_steps_fused / step_group,
whose counterpart on the card is a CUDA graph).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models.gaussians import (
    GaussianParams, GaussianPool, grow, one_up_sh_degree, reset_opacity,
    round_capacity,
)
from reduced3dgs_torch.ops.losses import l1_loss, ssim
from reduced3dgs_torch.ops.preprocess import CameraParams
from reduced3dgs_torch.renderer import render
from reduced3dgs_torch.train import adam, densify
from reduced3dgs_torch.train.adam import AdamState

# stage names of the events a marked train step records (see train_step)
TRAIN_STAGES = ("preprocess", "binning", "composite", "loss", "loss_bwd",
                "tile_bwd", "reduce", "preprocess_bwd", "adam")


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


def _mark(marks):
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)


def train_step(state: TrainState, cam: CameraParams, gt_image, background,
               iteration: int, *, width, height, budget, backend,
               opt_cfg: OptimizationParams, spatial_lr_scale: float,
               skip_update: bool = False, grad_reduce: str = "f32",
               marks=None):
    """One training iteration.  Returns (state, metrics) — and the
    gradients (a GaussianParams) when skip_update, for the host to replay
    the reference ordering backward -> surgery -> step.  metrics hold
    0-dim tensors on the device.  marks (on the card, "tile" backend): a
    list that receives one event as the render starts and one after each
    of TRAIN_STAGES."""
    pool, opt, gen = state
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
        screen_offset=screen_offset, marks=marks)
    ll1 = l1_loss(out.color, gt_image)
    lssim = 1.0 - ssim(out.color, gt_image)
    vis = out.visibility
    nvis = torch.clamp(vis.sum(), min=1)
    loss = (1.0 - opt_cfg.lambda_dssim) * ll1 + opt_cfg.lambda_dssim * lssim
    zero = torch.zeros((), dtype=torch.float32, device=pool.device)
    lalpha = lsh = zero
    if opt_cfg.lambda_alpha_regul > 0:
        op = torch.sigmoid(params.opacity[:, 0])
        lalpha = torch.where(vis, op.abs(), 0.0).sum() / nvis
        loss = loss + opt_cfg.lambda_alpha_regul * lalpha
    if opt_cfg.lambda_sh_sparsity > 0:
        lsh = torch.where(vis[:, None, None], params.features_rest.abs(),
                          0.0).sum() / (nvis * 45)
        loss = loss + opt_cfg.lambda_sh_sparsity * lsh
    _mark(marks)
    got = torch.autograd.grad(loss, leaves + [screen_offset],
                              allow_unused=True)
    _mark(marks)
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
            lr_tree = make_lr_tree(
                opt_cfg, _xyz_lr(iteration, opt_cfg, spatial_lr_scale))
            new_params, new_opt = adam.update(pool.params, grads, opt,
                                              lr_tree)
    _mark(marks)
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


def train_steps_fused(*args, **kw):
    """Several steps in one launch: the JAX package's way around the
    TPU's per-launch cost.  Its counterpart on the card (a CUDA graph) is
    not ported yet."""
    raise NotImplementedError(
        "fused steps (fused_steps > 1) are not ported yet; their "
        "counterpart on the card is a CUDA graph")


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
                 with_grads: bool = False, normals=None):
    """densify_and_prune; with_grads threads the pending gradients through
    the surgery (new rows zero, pruned rows dropped)."""
    pool, opt, gen = state
    max_screen = 20.0 if use_size_threshold else 0.0
    pool, opt, grads, stats = densify.densify_and_prune(
        pool, opt, opt_cfg.densify_grad_threshold, 0.005, extent,
        max_screen, opt_cfg.percent_dense,
        grads_tree=grads if with_grads else None, normals=normals,
        generator=gen)
    if with_grads:
        return TrainState(pool, opt, gen), stats, grads
    return TrainState(pool, opt, gen), stats


@torch.no_grad()
def mercy_step(state: TrainState, splat_counts, *, lambda_mercy,
               mercy_minimum, mercy_type, uniform=None):
    """mercy_points on the redundancy metric's per-primitive values; the
    coin flips of "redundancy_random" come from the state's generator
    (or `uniform`, see densify.mercy_points)."""
    pool, opt, gen = state
    pool, opt, stats = densify.mercy_points(
        pool, opt, splat_counts, lambda_mercy=lambda_mercy,
        mercy_minimum=mercy_minimum, mercy_type=mercy_type, generator=gen,
        uniform=uniform)
    return TrainState(pool, opt, gen), stats


@torch.no_grad()
def prune_dead_step(state: TrainState, extent):
    """prune(1/255) of dead points."""
    pool, opt, gen = state
    pool, opt, n = densify.prune(pool, opt, 1.0 / 255.0, extent, 0.0)
    return TrainState(pool, opt, gen), n


@torch.no_grad()
def opacity_reset_step(state: TrainState):
    """reset_opacity + zeroed opacity Adam moments."""
    pool, opt, gen = state
    opt = opt._replace(
        mu=opt.mu._replace(opacity=torch.zeros_like(opt.mu.opacity)),
        nu=opt.nu._replace(opacity=torch.zeros_like(opt.nu.opacity)))
    return TrainState(reset_opacity(pool), opt, gen)


def grow_leaf(x, old_cap, new_cap):
    """Pad a per-slot tensor with zero rows (other values pass)."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == old_cap:
        return torch.cat([x, x.new_zeros((new_cap - old_cap,)
                                         + x.shape[1:])])
    return x


def _grow_params(leaves, old_cap, new_cap):
    return type(leaves)(*(grow_leaf(x, old_cap, new_cap) for x in leaves))


class Trainer:
    """Host-side loop controller (the reference's training())."""

    def __init__(self, pool: GaussianPool, opt_cfg: OptimizationParams,
                 cameras, *, spatial_lr_scale: float, background,
                 backend: str = "tile", max_sh_degree: int = 3,
                 seed: int = 0, initial_budget: int = 1 << 17,
                 cull_sh_iterations=(), scene=None,
                 white_background: bool = False, grad_reduce: str = "f32"):
        self.opt_cfg = opt_cfg
        self.white_background = white_background
        self.cameras = list(cameras)
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.device = pool.device
        self.background = torch.as_tensor(background, dtype=torch.float32,
                                          device=self.device)
        self.backend = backend
        self.grad_reduce = grad_reduce
        self.max_sh_degree = max_sh_degree
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = TrainState(pool, adam.init(pool.params), gen)
        self.rng = np.random.default_rng(seed)
        self.initial_budget = initial_budget
        self.cull_sh_iterations = tuple(cull_sh_iterations)
        self.scene = scene  # the redundancy metric (mercy) needs it
        # start of the compression fine-tune phase: no mercy after it
        self.fine_tune_start = opt_cfg.iterations
        if self.cull_sh_iterations or opt_cfg.mercy_points:
            self.fine_tune_start = opt_cfg.iterations - 3000
        self._stack: list[int] = []
        self.budgets: dict[int, int] = {}  # camera uid -> instance budget
        self._gt: dict[int, torch.Tensor] = {}  # camera uid -> GT image
        self.extent = None  # set by the caller (scene cameras_extent)
        self.stats = {}
        self.iteration = 0

    # -- camera sampling: shuffle without replacement --------------------
    def _next_camera_idx(self):
        if not self._stack:
            self._stack = list(self.rng.permutation(len(self.cameras)))
        return self._stack.pop()

    def next_camera(self):
        return self.cameras[self._next_camera_idx()]

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
        will_mercy = (cfg.mercy_points and self.scene is not None
                      and iteration % (cfg.mercy_interval
                                       * cfg.densification_interval) == 0
                      and iteration <= self.fine_tune_start
                      and (iteration >= cfg.densify_until_iter
                           or iteration % cfg.opacity_reset_interval != 0))
        return will_densify, will_reset, will_prune_dead, will_mercy

    def step_group(self, iterations):
        return train_steps_fused(iterations)

    def _budget_for(self, cam_uid, needed=None):
        # {2^k, 3*2^(k-1)} ladder: slack stays below 25 %
        b = self.budgets.get(cam_uid, self.initial_budget)
        while needed is not None and needed > b:
            b = b // 2 * 3 if b & (b - 1) == 0 else b // 3 * 4
        self.budgets[cam_uid] = b
        return b

    def maybe_grow_pool(self, pending=None):
        n = int(self.state.pool.num_alive)
        cap = self.state.pool.capacity
        if n > 0.9 * cap:
            new_cap = round_capacity(cap * 2)
            pool = grow(self.state.pool, new_cap)
            opt = self.state.opt
            opt = opt._replace(mu=_grow_params(opt.mu, cap, new_cap),
                               nu=_grow_params(opt.nu, cap, new_cap))
            self.state = TrainState(pool, opt, self.state.generator)
            if pending is not None:
                pending = _grow_params(pending, cap, new_cap)
        return pending

    def step(self, iteration: int, marks=None):
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
        renders per training camera).  marks: see train_step (the last
        attempt's events).
        """
        cfg = self.opt_cfg
        self.iteration = iteration
        if iteration % 1000 == 0:
            self.state = self.state._replace(pool=one_up_sh_degree(
                self.state.pool, self.max_sh_degree))
        will_densify, will_reset, will_prune_dead, will_mercy = (
            self._events(iteration))
        surgery = will_densify or will_reset or will_prune_dead or will_mercy
        final = iteration >= cfg.iterations

        camera = self.next_camera()
        cp = camera.params(self.device)
        gt = self.gt_image(camera)
        background = self.background
        if cfg.random_background:
            background = torch.as_tensor(self.rng.uniform(0.0, 1.0, 3),
                                         dtype=torch.float32,
                                         device=self.device)
        while True:
            budget = self._budget_for(camera.uid)
            if marks is not None:
                marks.clear()
            out = train_step(
                self.state, cp, gt, background, iteration,
                width=camera.width, height=camera.height, budget=budget,
                backend=self.backend, opt_cfg=cfg,
                spatial_lr_scale=self.spatial_lr_scale,
                skip_update=surgery or final, grad_reduce=self.grad_reduce,
                marks=marks)
            st, metrics = out[0], out[1]
            grads = out[2] if len(out) == 3 else None
            needed = int(metrics["num_rendered"])
            if needed <= budget:
                break
            # overflow: grow the bucket and redo this step exactly
            # (same camera, same background)
            self._budget_for(camera.uid, needed)
        self.state = st

        pending = grads
        if will_densify:
            pending = self.maybe_grow_pool(pending)
            use_size = iteration > cfg.opacity_reset_interval
            if cfg.store_grads and pending is not None:
                self.state, dstats, pending = densify_step(
                    self.state, float(self.extent), pending, opt_cfg=cfg,
                    use_size_threshold=use_size, with_grads=True)
            else:
                self.state, dstats = densify_step(
                    self.state, float(self.extent), opt_cfg=cfg,
                    use_size_threshold=use_size)
                pending = None  # params rebuilt without store_grads
            self.stats.update({k: int(v) for k, v in dstats.items()})
        if will_reset:
            self.state = opacity_reset_step(self.state)
        if will_prune_dead:
            self.state, n = prune_dead_step(self.state, float(self.extent))
            self.stats["n_points_pruned"] = int(n)
            pending = None  # prune() is called without store_grads

        if will_mercy:
            self.scene.pool = self.state.pool
            red, _ = self.scene.calculate_redundancy_metric(
                pixel_scale=cfg.box_size)
            self.state, mstats = mercy_step(
                self.state, red, lambda_mercy=cfg.lambda_mercy,
                mercy_minimum=cfg.mercy_minimum, mercy_type=cfg.mercy_type)
            self.stats["n_points_mercied"] = int(mstats["n_points_mercied"])
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

            # one budget for every render of the cull, the largest any
            # camera has needed so far; an overflow is not redone
            pool = cull_sh_bands(
                self.state.pool, self.cameras,
                threshold=cfg.cdist_threshold * math.sqrt(3) / 255.0,
                std_threshold=cfg.std_threshold,
                budget=max(self.budgets.values(),
                           default=self.initial_budget),
                backend=self.backend, max_sh_degree=self.max_sh_degree,
                active_sh_degree=int(self.state.pool.active_sh_degree))
            self.state = self.state._replace(pool=pool)
        return metrics
