"""Multi-device training step on torch.distributed: a ("data", "tile") mesh.

Counterpart of reduced3dgs_tpu/parallel/sharded.py, one process per rank:

  * "data": data parallelism over cameras; data member d trains camera d
    of the step's batch;
  * "tile": inside a data member, preprocess runs on a 1/n_tile row shard
    of the pool and its outputs are all_gathered over the tile group (a
    differentiable gather: its backward is the reduce-scatter of the
    cotangent back to the owner rows); rasterisation is split into strips
    of tile rows, each rank bins and renders its own strip (K1-K4 with a
    tile base);
  * two parameter layouts: replicated (every rank holds the whole state;
    gradients get one all_reduce over the world) and ``param_shard=True``
    (every capacity-sized leaf, parameters and Adam moments alike, holds
    only this rank's cap / n_tile rows; the gradients come back through the
    gather's backward and get one all_reduce over the data group, and Adam
    steps the local rows).

The loss enters every all_reduce exactly once: each strip's L1, each
rank's band of the SSIM map (ops/losses.py:ssim_band_sum) on the gathered
image, the constant 1 of D-SSIM through tile member 0, the regularizers
through member 0 (replicated rows) or per owner row (sharded).  The sums
over ranks run outside the differentiated function, on the loss and on the
gradients, as in the JAX package (sharded.py:225-248).

Rank r sits at (r // n_tile, r % n_tile).  Without torch.distributed
initialised, a (1, 1) mesh runs with identity collectives.  The backend is
the caller's (parallel/launch.py: nccl for cuda, gloo for cpu); nothing
here moves a tensor to the host so that a collective works.

Surgery on row shards (``ShardRows``, ``ShardedTrainer`` with
param_shard): every event of Trainer._surgery runs on each rank's rows,
and no rank holds the whole state.  A decision that needs the whole pool
(free slots, thresholds, the redundancy metric) runs on every rank on
single columns all_gathered over the tile group (1-41 B a row), so every
rank computes the single-card decision bit for bit; its application is
row-local.  Rows that a densify or a capacity growth sends to another
rank move there (one padded all_gather, or one broadcast per leaf and
source rank); counts are all_reduced as integers; the SH cull renders
each rank's strip of tile rows and reduce-scatters the per-primitive
transmittance sums to their owners.  The layout stays the contiguous one
of shard_state, so every row lies where the single-card surgery puts it.

Fused steps (``sharded_fused_step``, ``ShardedTrainer.step_group``): the
sharded step on the static buffers of train/trainer.py (this rank's rows
or the whole state, the step vector, the ground truth), captured once as a
CUDA graph with its NCCL collectives inside and replayed; the CPU runs it
in a loop under gloo.  Gloo's collectives on CUDA tensors cannot be
captured: a graph asked for under gloo on the card raises.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.distributed as dist

from reduced3dgs_torch.cameras import camera_from_vector
from reduced3dgs_torch.config import OptimizationParams
from reduced3dgs_torch.models.gaussians import (
    GaussianParams, one_up_sh_degree,
)
from reduced3dgs_torch.ops import binning as binning_ops
from reduced3dgs_torch.ops import preprocess as prep_ops
from reduced3dgs_torch.ops.losses import abs_jax, ssim_band_sum
from reduced3dgs_torch.ops.preprocess import TILE_Y, tile_grid
from reduced3dgs_torch.ops.tile_render import (
    tile_render, transmittance_by_primitive,
)
from reduced3dgs_torch.renderer import overflow_report
from reduced3dgs_torch.train import adam
from reduced3dgs_torch.train import trainer as trainer_mod
from reduced3dgs_torch.train.trainer import (
    VEC_ADAM, VEC_BG, TrainState, Trainer, _xyz_lr, adam_scalars,
    make_lr_tree,
)

# PreprocessOut fields gathered over the tile group: floats (those with a
# gradient among them) in one tensor, integers in another
_FLOAT_FIELDS = (("means2d", 2), ("depths", 1), ("conic", 3),
                 ("opacity", 1), ("color", 3))
_INT_FIELDS = (("radii", 1), ("rect_min", 2), ("rect_max", 2),
               ("tiles_touched", 1))
# a sharded step's metrics as a fused step's buffers hold them: the float
# ones, then the int32 ones with the budget's demand first
SHARDED_METRICS = (("loss", "l1"), ("num_rendered_max", "num_alive"))
# run_sharded_step_with_regrow: the budget's factor a growth, and the most
# growths before it gives up
REGROW_GROWTH = 2
REGROW_MAX = 24


class Mesh:
    """This rank's place on an (n_data, n_tile) mesh and its groups.

    ``world``, ``tile`` (the ranks of this data index) and ``data`` (the
    ranks of this tile index) are process groups, made with
    dist.new_group on every rank in the same order, or None when
    torch.distributed is not initialised or `alone` is set (a (1, 1) mesh
    of this rank by itself: collectives are identities)."""

    def __init__(self, n_data: int, n_tile: int, alone: bool = False):
        initialised = (dist.is_available() and dist.is_initialized()
                       and not alone)
        world = dist.get_world_size() if initialised else 1
        if n_data * n_tile != world:
            raise ValueError(f"a {n_data}x{n_tile} mesh needs "
                             f"{n_data * n_tile} ranks, the world has {world}")
        self.n_data, self.n_tile = n_data, n_tile
        self.rank = dist.get_rank() if initialised else 0
        self.data_idx, self.tile_idx = divmod(self.rank, n_tile)
        self.world = self.tile = self.data = None
        if initialised:
            self.world = dist.group.WORLD
            tiles = [dist.new_group([d * n_tile + t for t in range(n_tile)])
                     for d in range(n_data)]
            datas = [dist.new_group([d * n_tile + t for d in range(n_data)])
                     for t in range(n_tile)]
            self.tile = tiles[self.data_idx]
            self.data = datas[self.tile_idx]

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "tile": self.n_tile}


def make_mesh(n_data: int, n_tile: int) -> Mesh:
    return Mesh(n_data, n_tile)


def camera_mesh(mesh: Mesh) -> Mesh:
    """The mesh of a step with one camera for the whole mesh: `mesh`
    itself when n_data is 1, else this rank's tile group as a (1, n_tile)
    mesh (its world the tile group, no data group), so that every data
    group runs the camera on its own tile group and nothing is summed over
    the data axis."""
    if mesh.n_data == 1:
        return mesh
    sub = copy.copy(mesh)
    sub.n_data, sub.data_idx = 1, 0
    sub.world, sub.data = mesh.tile, None
    return sub


def refuse_uncapturable(mesh: Mesh):
    """Raise unless every collective of `mesh` can be captured in a CUDA
    graph: NCCL's can, gloo's on CUDA tensors cannot."""
    groups = [g for g in (mesh.world, mesh.tile, mesh.data) if g is not None]
    other = sorted({dist.get_backend(g) for g in groups} - {"nccl"})
    if other:
        raise RuntimeError(
            f"a CUDA graph of the sharded step needs NCCL collectives: "
            f"{'/'.join(other)} collectives on CUDA tensors cannot be "
            f"captured; run the ranks under nccl, or ShardedTrainer.step")


def stack_camera_params(cams, device=None):
    """One CameraParams per data member (cameras or CameraParams)."""
    return [c.params(device) if hasattr(c, "params") else c for c in cams]


# ---------------------------------------------------------------------------
# collectives (identities on a mesh without groups)
# ---------------------------------------------------------------------------

def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def all_reduce(x, group, op=None):
    """x summed (or reduced by `op`) over the group, as a new tensor."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return x


def all_gather_rows(x, group):
    """The group's tensors concatenated on rows, in rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _nccl(group):
        out = x.new_empty((n * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def reduce_scatter_rows(x, group):
    """This rank's block of rows of the group's sum of x."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _nccl(group):
        out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    x = x.clone()
    dist.all_reduce(x, group=group)  # gloo has no reduce_scatter
    return x.chunk(n)[dist.get_rank(group)].clone()


class _GatherRows(torch.autograd.Function):
    """all_gather over a group, concatenated on rows; the backward is the
    reduce-scatter of the cotangent to each rank's own rows (the
    all_gather transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


def gather_rows(x, group):
    """Differentiable all_gather_rows."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


def _gather_prep(prep, group, note=None):
    """A PreprocessOut of this rank's rows -> the tile group's whole one
    (64 B a row).  note: called with each gathered tensor."""
    fl = gather_rows(torch.cat(
        [getattr(prep, f).reshape(-1, n) for f, n in _FLOAT_FIELDS], 1),
        group)
    it = all_gather_rows(torch.cat(
        [getattr(prep, f).reshape(-1, n) for f, n in _INT_FIELDS], 1),
        group)
    if note is not None:
        note(fl)
        note(it)
    out = {}
    for src, fields in ((fl, _FLOAT_FIELDS), (it, _INT_FIELDS)):
        c = 0
        for f, n in fields:
            out[f] = src[:, c] if f in ("depths", "opacity", "radii",
                                        "tiles_touched") else src[:, c:c + n]
            c += n
    return prep_ops.PreprocessOut(**out)


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    out, c = [], 0
    for t in like:
        out.append(flat[c:c + t.numel()].reshape(t.shape))
        c += t.numel()
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def sharded_train_step(state: TrainState, cams, gts, background, iteration,
                       *, mesh: Mesh, width: int, height: int, budget: int,
                       opt_cfg: OptimizationParams, spatial_lr_scale: float,
                       param_shard: bool = False, skip_update: bool = False,
                       grad_reduce: str = "f32", adam_scalars=None):
    """One data + tile parallel training iteration on this rank.

    cams: n_data CameraParams (stack_camera_params), gts: n_data (H, W, 3)
    images; data member d uses cams[d] and gts[d].  state: the whole state
    (replicated) or, with param_shard, this rank's rows of every
    capacity-sized leaf (shard_state).  Returns (state, metrics), or
    (state, metrics, grads) with skip_update (the host replays the
    gradients after surgery); metrics: "loss", "l1", "num_alive" and
    "num_rendered_max" (the largest strip demand over the mesh, the
    overflow report), 0-dim tensors equal on every rank.  adam_scalars:
    as train_step's (the 0-dim device tensors Trainer.step hands Adam)."""
    pool, opt, gen = state
    nd, nt = mesh.n_data, mesh.n_tile
    t_idx = mesh.tile_idx
    cap = pool.capacity * nt if param_shard else pool.capacity
    if cap % nt:
        raise ValueError("the pool capacity must divide the tile axis")
    cs = cap // nt
    grid_x, grid_y = tile_grid(width, height)
    rows_per = -(-grid_y // nt)  # strip rows per rank
    hw3 = height * width * 3
    lam = opt_cfg.lambda_dssim
    cam, gt = cams[mesh.data_idx], gts[mesh.data_idx]
    dev = pool.device

    leaves = [p.detach().requires_grad_(True) for p in pool.params]
    params = GaussianParams(*leaves)
    screen_offset = torch.zeros((pool.capacity, 2), dtype=torch.float32,
                                device=dev, requires_grad=True)
    # param_shard: the leaves are this rank's rows already
    own = slice(None) if param_shard else slice(t_idx * cs, (t_idx + 1) * cs)
    feats = torch.cat([params.features_dc, params.features_rest], dim=1)
    prep_local = prep_ops.preprocess(
        params.xyz[own], params.scaling[own], params.rotation[own],
        params.opacity[own, 0], feats[own], pool.degrees[own], cam,
        alive_mask=pool.alive[own], screen_offset=screen_offset[own])
    prep = _gather_prep(prep_local, mesh.tile)

    # --- this rank's strip ----------------------------------------------
    r0 = t_idx * rows_per
    b = binning_ops.bin_gaussians(prep, width, height, budget,
                                  tile_rows=(r0, rows_per))
    strip = tile_render(prep, b, background, width, height,
                        tile_rows=(r0, rows_per), grad_reduce=grad_reduce)[0]
    num_rendered = overflow_report(b, budget)  # the strip's demand

    y0, n_rows = r0 * TILE_Y, rows_per * TILE_Y
    gt_pad = torch.cat([gt, gt.new_zeros((nt * n_rows - height,)
                                         + gt.shape[1:])])
    row_ok = (y0 + torch.arange(n_rows, device=dev) < height)[:, None, None]
    l1_sum = torch.where(row_ok, (strip - gt_pad[y0:y0 + n_rows]).abs(),
                         0.0).sum()
    l1_term = (1.0 - lam) * (l1_sum / (nd * hw3))  # l1_loss's rounding

    # the gathered image; each rank sums its band of the SSIM map
    img = gather_rows(strip, mesh.tile)[:height]
    band = -(-height // nt)
    s_sum = ssim_band_sum(img, gt, t_idx * band, band)
    gated = lam * (-s_sum / float(hw3))
    if param_shard:
        # disjoint owner rows: the visible count is global, each row's
        # |.| enters once through its owner
        vis = prep_local.radii > 0
        nvis = torch.clamp(all_reduce(vis.sum(), mesh.tile), min=1)
        gate_rows = 1.0
    else:
        vis = prep.radii > 0
        nvis = torch.clamp(vis.sum(), min=1)
        gate_rows = 1.0 if t_idx == 0 else 0.0  # replicated rows: once
    reg = torch.zeros((), dtype=torch.float32, device=dev)
    if opt_cfg.lambda_alpha_regul > 0:
        op = torch.sigmoid(params.opacity[:, 0])
        reg = reg + opt_cfg.lambda_alpha_regul * (
            torch.where(vis, abs_jax(op), 0.0).sum() / nvis)
    if opt_cfg.lambda_sh_sparsity > 0:
        rest = torch.where(vis[:, None, None],
                           abs_jax(params.features_rest), 0.0)
        reg = reg + opt_cfg.lambda_sh_sparsity * (rest.sum() / (nvis * 45))
    const = lam if t_idx == 0 else 0.0
    loss_local = l1_term + (gated + const + gate_rows * reg) / nd

    # this rank's contribution only; the sums over ranks come after
    got = torch.autograd.grad(loss_local, leaves + [screen_offset],
                              allow_unused=True)
    g_local = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, got[:-1])]
    g_so = got[-1]

    with torch.no_grad():
        scal = all_reduce(torch.stack([loss_local.detach(),
                                       l1_sum.detach()]), mesh.world)
        loss, l1_mean = scal[0], scal[1] / (nd * hw3)
        if param_shard:
            # owner rows already: only the camera batch is left to sum
            grads = _unflat(all_reduce(_flat(g_local), mesh.data), g_local)
            radii_own = prep.radii[t_idx * cs:(t_idx + 1) * cs]
        else:
            grads = _unflat(all_reduce(_flat(g_local), mesh.world), g_local)
            g_so = all_reduce(g_so, mesh.tile)
            radii_own = prep.radii
        grads = GaussianParams(*grads)
        nr_max = all_reduce(num_rendered.to(torch.int32), mesh.world,
                            dist.ReduceOp.MAX)

        # densification statistics, summed over the camera batch
        gx = g_so[:, 0] * (0.5 * width)
        gy = g_so[:, 1] * (0.5 * height)
        gnorm = torch.sqrt(gx * gx + gy * gy)
        sums = all_reduce(torch.stack([torch.where(vis, gnorm, 0.0),
                                       vis.to(torch.float32)]), mesh.data)
        rad = all_reduce(torch.where(vis, radii_own, 0).to(torch.float32),
                         mesh.data, dist.ReduceOp.MAX)
        pool = pool.replace(
            xyz_grad_accum=pool.xyz_grad_accum + sums[0],
            denom=pool.denom + sums[1],
            max_radii2d=torch.maximum(pool.max_radii2d, rad))
        if skip_update:
            new_params, new_opt = pool.params, opt
        else:
            lr_xyz, bias = (
                (_xyz_lr(iteration, opt_cfg, spatial_lr_scale), None)
                if adam_scalars is None else adam_scalars)
            new_params, new_opt = adam.update(
                pool.params, grads, opt, make_lr_tree(opt_cfg, lr_xyz),
                bias=bias)
        pool = pool.replace(params=new_params)
        num_alive = pool.num_alive
        if param_shard:
            num_alive = all_reduce(num_alive, mesh.tile)
    metrics = {"loss": loss, "l1": l1_mean, "num_alive": num_alive,
               "num_rendered_max": nr_max}
    state = TrainState(pool, new_opt, gen)
    if skip_update:
        return state, metrics, grads
    return state, metrics


def sharded_fused_step(buf, *, mesh: Mesh, param_shard: bool, width,
                       height, budget, opt_cfg: OptimizationParams,
                       grad_reduce: str, active_sh_degree: int):
    """One sharded non-surgery step on a trainer.FusedBuffers (this rank's
    rows with param_shard, else the whole state; metrics SHARDED_METRICS):
    reads the state, the step vector (this rank's camera, the background,
    the Adam scalars) and the ground truth there, and writes the new
    state and the metrics back in place.  The step a CUDA graph captures:
    sharded_train_step with every data member's camera the vector's
    (only this rank's data member's is read)."""
    cam = camera_from_vector(buf.vec, width, height)
    state, metrics = sharded_train_step(
        buf.state(active_sh_degree), [cam] * mesh.n_data,
        [buf.gt] * mesh.n_data, buf.vec[VEC_BG], 0, mesh=mesh, width=width,
        height=height, budget=budget, opt_cfg=opt_cfg, spatial_lr_scale=0.0,
        param_shard=param_shard, grad_reduce=grad_reduce,
        adam_scalars=adam_scalars(buf.vec[VEC_ADAM:]))
    buf.store(state, metrics)


def run_sharded_step_with_regrow(state, cams, gts, background, iteration, *,
                                 mesh, width, height, budget, opt_cfg,
                                 spatial_lr_scale, param_shard=False,
                                 skip_update=False, grad_reduce="f32",
                                 adam_scalars=None):
    """The single-card overflow contract on the mesh: where a strip's
    demand exceeded the budget, multiply the budget by REGROW_GROWTH
    until it covers the demand and redo the step from the same state; at
    most REGROW_MAX growths, then RuntimeError.  Returns (state, metrics,
    budget) (+ grads with skip_update).  It doubles, not climbs
    renderer.next_budget's ladder: that is the JAX package's mesh contract
    (reduced3dgs_tpu/parallel/sharded.py), which the mesh tests compare."""
    needed = None
    for _ in range(REGROW_MAX + 1):
        out = sharded_train_step(
            state, cams, gts, background, iteration, mesh=mesh, width=width,
            height=height, budget=budget, opt_cfg=opt_cfg,
            spatial_lr_scale=spatial_lr_scale, param_shard=param_shard,
            skip_update=skip_update, grad_reduce=grad_reduce,
            adam_scalars=adam_scalars)
        needed = int(out[1]["num_rendered_max"])
        if needed <= budget:
            return (out[0], out[1], budget) + tuple(out[2:])
        while budget < needed:
            budget *= REGROW_GROWTH
    raise RuntimeError(
        f"instance-budget regrowth did not converge after {REGROW_MAX} "
        f"growths (budget={budget}, demand={needed})")


# ---------------------------------------------------------------------------
# state layout
# ---------------------------------------------------------------------------

def _map_rows(state: TrainState, cap: int, fn):
    """state with fn applied to every tensor whose leading axis is cap."""
    def leaf(x):
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == cap:
            return fn(x)
        return x

    pool, opt, gen = state
    pool = pool.replace(
        params=GaussianParams(*(leaf(x) for x in pool.params)),
        **{k: leaf(getattr(pool, k)) for k in (
            "degrees", "alive", "max_radii2d", "xyz_grad_accum", "denom")})
    opt = opt._replace(mu=GaussianParams(*(leaf(x) for x in opt.mu)),
                       nu=GaussianParams(*(leaf(x) for x in opt.nu)))
    return TrainState(pool, opt, gen)


def shard_state(state: TrainState, mesh: Mesh,
                param_shard: bool = True) -> TrainState:
    """The whole state -> this rank's layout: with param_shard its rows
    [t cap/n_tile, (t+1) cap/n_tile) of every capacity-sized leaf (copies),
    else the state itself (replicated)."""
    if not param_shard:
        return state
    cap = state.pool.capacity
    if cap % mesh.n_tile:
        raise ValueError("the pool capacity must divide the tile axis")
    cs = cap // mesh.n_tile
    lo = mesh.tile_idx * cs
    return _map_rows(state, cap, lambda x: x[lo:lo + cs].clone())


def _as_words(fn):
    """fn on a tensor, bool tensors passed as uint8 (not every backend
    carries bool)."""
    def run(x):
        if x.dtype == torch.bool:
            return fn(x.to(torch.uint8)).bool()
        return fn(x)
    return run


def gather_state(state: TrainState, mesh: Mesh,
                 param_shard: bool = True) -> TrainState:
    """shard_state's inverse: the tile group's row shards all_gathered
    into the whole state."""
    if not param_shard:
        return state
    return _map_rows(state, state.pool.capacity,
                     _as_words(lambda x: all_gather_rows(x, mesh.tile)))


def sync_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Every capacity-sized tensor of the whole state as rank 0 holds it
    (a broadcast over the world), so that ranks that ran the same surgery
    hold the same bits even where a kernel's float atomics differ."""
    if mesh.world is None or dist.get_world_size() == 1:
        return state

    def bcast(x):
        x = x.contiguous()
        dist.broadcast(x, 0, group=mesh.world)
        return x

    return _map_rows(state, state.pool.capacity, _as_words(bcast))


def broadcast(x, src: int, group):
    """x as member `src` of the group holds it (in place; x contiguous)."""
    if group is not None:
        dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return x


def _words(x):
    """A (n, ...) tensor of 4-byte elements as (n, w) int32 words."""
    if x.element_size() != 4:
        raise ValueError(f"rows of {x.dtype} do not travel as words")
    return x.reshape(x.shape[0], math.prod(x.shape[1:])).contiguous().view(
        torch.int32)


# the most bytes per global capacity row of one broadcast piece
_PIECE_BYTES_PER_ROW = 64


class ShardRows:
    """This rank's contiguous row shard of the pool (shard_state's layout)
    as the surgery's row layout: the methods of train/densify.py:WholeRows
    over the tile group.  Decisions read whole single columns
    all_gathered over it; rows a decision sends to another member move
    there; counts are all_reduced as integers.

    log: None, or a list that receives one dict per collective run here:
    "op", "bytes" (its output on this rank), "capacity" (the pool's
    global capacity then) and "move" (it carries rows to a new owner)."""

    def __init__(self, mesh: Mesh, log=None):
        self.mesh, self.log = mesh, log
        self.group, self.n, self.t = mesh.tile, mesh.n_tile, mesh.tile_idx

    def _note(self, op, out, capacity, move=False):
        if self.log is not None:
            self.log.append(dict(op=op, move=move, capacity=capacity,
                                 bytes=out.numel() * out.element_size()))
        return out

    def capacity(self, pool):
        return pool.capacity * self.n

    def column(self, x):
        """The tile group's whole column of a per-row tensor."""
        whole = _as_words(lambda v: all_gather_rows(v, self.group))(x)
        return self._note("all_gather", whole, x.shape[0] * self.n)

    def mine(self, x, dim=0):
        cs = x.shape[dim] // self.n
        return x.narrow(dim, self.t * cs, cs)

    def total(self, mask):
        return self._note("all_reduce", all_reduce(mask.sum(), self.group),
                          mask.shape[0] * self.n)

    def put(self, leaves, src_leaves, src, dst):
        """WholeRows.put on shards (src, dst: global rows, the same on
        every member).  A row whose source and destination have one owner
        is copied there; the others travel in one all_gather of every
        member's outgoing rows (4-byte words, padded to the largest
        count).  Returns (new leaves, local positions of the dst rows held
        here)."""
        cs = leaves[0].shape[0]
        lo, n = self.t * cs, self.n
        s_own, d_own = src // cs, dst // cs
        away = s_own != d_own
        here = d_own == self.t
        out = [x.clone() for x in leaves]
        stay = here & ~away
        for x, v in zip(out, src_leaves):
            x[dst[stay] - lo] = v[src[stay] - lo]
        counts = torch.bincount(s_own[away], minlength=n)
        n_max = int(counts.max())
        if n_max:
            send = away & (s_own == self.t)
            words = torch.cat([_words(v[src[send] - lo])
                               for v in src_leaves], 1)
            words = torch.cat([words, words.new_zeros(
                (n_max - words.shape[0], words.shape[1]))])
            got = self._note("all_gather",
                             all_gather_rows(words, self.group), cs * n,
                             move=True)
            # a sender's outgoing rows in source order (src increases)
            first = torch.cumsum(counts, 0) - counts
            pos = (s_own * n_max + torch.cumsum(away.to(torch.int64), 0)
                   - 1 - first[s_own])
            take = away & here
            got = got[pos[take]]
            c = 0
            for x, v in zip(out, src_leaves):
                w = math.prod(v.shape[1:])
                x[dst[take] - lo] = got[:, c:c + w].contiguous().view(
                    x.dtype).reshape((-1,) + x.shape[1:])
                c += w
        return out, dst[here] - lo

    def grow(self, pool, opt, pending, new_cap):
        """WholeRows.grow on shards: the new layout's shard of every
        capacity-sized leaf (new_cap / n_tile rows, global row g on member
        g // (new_cap / n_tile)).  Member r's old rows go to their new
        owners by one broadcast per leaf, so that a member holds its old
        shard, its new one and one leaf of one other member's shard at a
        time; after a doubling, the members above the old rows hold dead
        slots only until densify fills them."""
        n, cs = self.n, pool.capacity
        if new_cap % n:
            raise ValueError("the pool capacity must divide the tile axis")
        ncs = new_cap // n

        def move(x, identity=False):
            if x.dtype == torch.bool:  # not every backend carries bool
                return move(x.to(torch.uint8)).bool()
            new = x.new_zeros((ncs,) + x.shape[1:])
            if identity:
                new[:, 0] = 1
            for r in range(n):
                a, b = r * cs, (r + 1) * cs
                owners = range(a // ncs, (b - 1) // ncs + 1)
                buf = x if r == self.t else None
                if any(o != r for o in owners):
                    buf = broadcast(x.contiguous() if r == self.t
                                    else torch.empty_like(x), r, self.group)
                    self._note("broadcast", buf, new_cap, move=True)
                if buf is not None and self.t in owners:
                    lo = max(a, self.t * ncs)
                    hi = min(b, (self.t + 1) * ncs)
                    new[lo - self.t * ncs:hi - self.t * ncs] = buf[lo - a:
                                                                  hi - a]
            return new

        def params(leaves, identity=False):
            return type(leaves)(*(
                move(x, identity and name == "rotation")
                for name, x in zip(leaves._fields, leaves)))

        pool = pool.replace(
            params=params(pool.params, identity=True),
            **{k: move(getattr(pool, k)) for k in (
                "degrees", "alive", "max_radii2d", "xyz_grad_accum",
                "denom")})
        opt = opt._replace(mu=params(opt.mu), nu=params(opt.nu))
        if pending is not None:
            pending = params(pending)
        return pool, opt, pending

    @torch.inference_mode()
    def transmittance(self, pool, features, cam, *, budget, backend):
        """sh_culling.render_transmittance over the tile group: preprocess
        on this member's rows, its outputs all_gathered (64 B a row), this
        member's strip of tile rows binned and walked by K4 at its tile
        base, the per-primitive sums reduce-scattered to their owners.
        Returns (radii, trans_sum, touched) of this member's rows; the
        sums run in another order than the whole frame's.  backend: the
        strips are the tile renderer's."""
        if backend != "tile":
            raise NotImplementedError("strips are the tile backend's")
        cap = self.capacity(pool)
        p = pool.params
        prep_local = prep_ops.preprocess(
            p.xyz, p.scaling, p.rotation, p.opacity[:, 0], features,
            pool.degrees, cam, alive_mask=pool.alive)
        prep = _gather_prep(prep_local, self.group,
                            lambda out: self._note("all_gather", out, cap))
        width, height = cam.width, cam.height
        grid_x, grid_y = tile_grid(width, height)
        rows_per = -(-grid_y // self.n)
        r0 = self.t * rows_per
        b = binning_ops.bin_gaussians(prep, width, height, budget,
                                      tile_rows=(r0, rows_per))
        t_sum, touched = transmittance_by_primitive(b, width, height,
                                                    r0 * grid_x)
        sums = self._note("reduce_scatter", reduce_scatter_rows(
            torch.stack([t_sum, touched.to(torch.float32)], 1), self.group),
            cap)
        return prep_local.radii, sums[:, 0], sums[:, 1].to(torch.int32)

    def agree(self, state: TrainState) -> TrainState:
        """Every capacity-sized leaf of this member's shard as data member
        0 of its tile index holds it: a broadcast over the data group,
        leaf by leaf, in pieces of at most 64 B a global capacity row (the
        data groups ran the same surgery; float atomics may differ)."""
        data = self.mesh.data
        cs = state.pool.capacity
        cap = cs * self.n

        def bcast(x):
            x = x.contiguous()
            flat = x.view(-1)
            for piece in flat.split(_PIECE_BYTES_PER_ROW * cap
                                    // x.element_size()):
                self._note("broadcast", broadcast(piece, 0, data), cap)
            return x

        return _map_rows(state, cs, _as_words(bcast))


class ShardedTrainer(Trainer):
    """The single-card Trainer's event cadence (SH schedule, densify /
    prune / mercy / opacity reset, the store_grads deferred step, SH
    culls) on an (n_data, n_tile) mesh.

    Plain iterations run run_sharded_step_with_regrow (one camera per
    data member).  Surgery iterations run Trainer._surgery's one sequence
    of events on the state's row layout ``self.rows``: with param_shard a
    ShardRows (every event on this rank's rows, the pending gradients
    sharded, no whole state on any rank; the counterpart of GSPMD
    partitioning the JAX package's surgery steps), after which, with
    n_data > 1, each rank's shard is broadcast from data member 0 over its
    data group; replicated, the whole state, then rank 0's result
    broadcast over the world.  Every rank must hold the same cameras,
    seed and initial pool.  Set ``rows.log`` to a list to record the
    surgery's collectives (ShardRows)."""

    def __init__(self, pool, opt_cfg, cameras, *, mesh: Mesh,
                 param_shard: bool = True, **kw):
        super().__init__(pool, opt_cfg, cameras, **kw)
        self.mesh = mesh
        self.param_shard = param_shard
        self.n_data = mesh.n_data
        self.state = shard_state(self.state, mesh, param_shard)
        self._camera_mesh = camera_mesh(mesh)
        if param_shard:
            self.rows = ShardRows(mesh)

    def step_group(self, iterations):
        """Trainer.step_group on the mesh, as the JAX package's
        ShardedTrainer inherits it: one camera per iteration, popped and
        its random background drawn in step()'s order, a same-resolution
        prefix, one budget and one host read per group, the whole group
        re-run on overflow.  Each iteration is sharded_fused_step with
        that camera on camera_mesh (n_data > 1: every data group runs it
        on its own tile group, the single-chip step the JAX method
        computes), replayed from one CUDA graph on the card (it raises
        under gloo there) and looped on the CPU.  Returns the
        per-iteration metrics of ShardedTrainer.step."""
        if self.device.type == "cuda":
            refuse_uncapturable(self.mesh)
        return super().step_group(iterations)

    def _fused_step(self):
        return (sharded_fused_step,
                dict(mesh=self._camera_mesh, param_shard=self.param_shard),
                SHARDED_METRICS)

    def step(self, iteration: int):
        """One sharded iteration, in the single-card order: backward ->
        surgery -> deferred optimizer step."""
        cfg = self.opt_cfg
        self.iteration = iteration
        if iteration % trainer_mod.SH_DEGREE_INTERVAL == 0:
            self.state = self.state._replace(pool=one_up_sh_degree(
                self.state.pool, self.max_sh_degree))
        events = self._events(iteration)
        surgery = any(events)
        final = iteration >= cfg.iterations

        cams = [self.next_camera() for _ in range(self.n_data)]
        scalars = None
        if not (surgery or final):
            # the scalars Trainer.step hands Adam, as 0-dim device tensors
            # (on the card a division by a Python float is a product with
            # its reciprocal: another rounding)
            scalars = adam_scalars(torch.as_tensor(
                self._adam_scalars(iteration), device=self.device))
        background = self.background
        if cfg.random_background:
            background = torch.as_tensor(self.rng.uniform(0.0, 1.0, 3),
                                         dtype=torch.float32,
                                         device=self.device)
        gts = [self.gt_image(c) for c in cams]
        budget = max(self._budget_for(c.uid) for c in cams)
        out = run_sharded_step_with_regrow(
            self.state, stack_camera_params(cams, self.device), gts,
            background, iteration, mesh=self.mesh, width=cams[0].width,
            height=cams[0].height, budget=budget, opt_cfg=cfg,
            spatial_lr_scale=self.spatial_lr_scale,
            param_shard=self.param_shard, skip_update=surgery or final,
            grad_reduce=self.grad_reduce, adam_scalars=scalars)
        self.state, metrics, new_budget = out[0], out[1], out[2]
        pending = out[3] if len(out) > 3 else None
        for c in cams:
            self._budget_for(c.uid, new_budget)

        if surgery or iteration in self.cull_sh_iterations:
            self._surgery(iteration, pending, final)
            if not self.param_shard:
                self.state = sync_state(self.state, self.mesh)
            elif self.n_data > 1:
                self.state = self.rows.agree(self.state)
        return metrics
