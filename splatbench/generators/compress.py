"""The `compress` traffic: the compression iteration of the paper's
`full_final` schedule through the program's Trainer, and the fused
iterations after it, every cycle from one device snapshot.

Set-up builds the `train` traffic's Trainer at the traffic's
`first_iteration` (the seeded state in mid-training, every camera's
ground truth and instance budget) and asks the program which surgeries
Trainer.step runs there (Trainer.events_at): it stops unless they are
the dead-prune, mercy and the SH-band cull.  It then snapshots the
trainer (its pool, Adam's moments and step counts, the generator's
state, the camera order and the budgets).  A cycle restores the
snapshot, runs Trainer.step at `first_iteration` (the dead-prune, mercy
with its 30-neighbour search, the cull's two transmittance renders a
camera) and one Trainer.step_group of the next `cycle_iterations` - 1
iterations on the pruned, culled pool.  The window runs whole cycles, so
its iterations do not depend on where the seconds fall.

The first cycle runs before the window on the same path, spied where the
checks need it: the dead-prune's masks, the kNN's neighbour lists,
mercy's state and result, and each transmittance render's per-primitive
sums, which feed the reference's two cull passes camera by camera (the
sums of 2 x cameras renders do not fit beside the pool).  Its step group
runs as groups of 1, check_steps - 1 and the rest (one captured step,
the same bits) so that the first gradient and the change after
check_steps iterations can be read.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from splatbench import scene
from splatbench.generators.train import (
    LEAVES, Train, camera_order, extent, json_line, state_inputs, view_of,
)
from splatbench.reference import compress as ref
from splatbench.reference import full_precision, raster
from splatbench.reference import train as ref_train

EVENTS = ("prune_dead", "mercy", "cull")
KNN_QUERIES = 65536  # sampled alive rows whose 30 neighbours are checked


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def snapshot(tr):
    """The trainer's state and host schedule, copied."""
    from reduced3dgs_torch.train.adam import AdamState

    st = tr.state
    pool = st.pool
    leaves = type(pool.params)(*(t.clone() for t in pool.params))
    return dict(
        pool=pool.replace(
            params=leaves, degrees=pool.degrees.clone(),
            alive=pool.alive.clone(), max_radii2d=pool.max_radii2d.clone(),
            xyz_grad_accum=pool.xyz_grad_accum.clone(),
            denom=pool.denom.clone()),
        opt=AdamState(mu=type(st.opt.mu)(*(t.clone() for t in st.opt.mu)),
                      nu=type(st.opt.nu)(*(t.clone() for t in st.opt.nu)),
                      step=st.opt.step),
        generator=st.generator.get_state(),
        rng=tr.rng.bit_generator.state, stack=list(tr._stack),
        budgets=dict(tr.budgets))


def restore(tr, snap):
    """The trainer as `snapshot` found it (the snapshot is not written)."""
    from reduced3dgs_torch.train.adam import AdamState
    from reduced3dgs_torch.train.trainer import TrainState

    pool = snap["pool"]
    st = tr.state
    st.generator.set_state(snap["generator"])
    tr.state = TrainState(
        pool.replace(
            params=type(pool.params)(*(t.clone() for t in pool.params)),
            degrees=pool.degrees.clone(), alive=pool.alive.clone(),
            max_radii2d=pool.max_radii2d.clone(),
            xyz_grad_accum=pool.xyz_grad_accum.clone(),
            denom=pool.denom.clone()),
        AdamState(mu=type(pool.params)(*(t.clone()
                                          for t in snap["opt"].mu)),
                  nu=type(pool.params)(*(t.clone()
                                         for t in snap["opt"].nu)),
                  step=snap["opt"].step),
        st.generator)
    tr.rng.bit_generator.state = snap["rng"]
    tr._stack = list(snap["stack"])
    tr.budgets = dict(snap["budgets"])


class Compress:
    """One cell's trainer, its snapshot, its cycles and its readings."""

    def __init__(self, cfg, traffic, seed: int, device):
        from reduced3dgs_torch.train.trainer import Trainer

        if not hasattr(Trainer, "events_at"):
            raise RuntimeError(
                "the program's Trainer does not name the surgeries of an "
                "iteration (Trainer.events_at): the compress traffic cannot "
                "tell that its iteration runs mercy and the SH-band cull")
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, \
            device
        self.at = traffic["first_iteration"]
        self.run = Train(cfg, traffic, seed, device)
        tr = self.trainer = self.run.trainer
        found = tr.events_at(self.at)
        if not set(EVENTS) <= set(found):
            raise RuntimeError(
                f"Trainer.step({self.at}) runs {found}, not the dead-prune, "
                "mercy and the SH-band cull")
        self.budget = self.run.budget
        self.snap = snapshot(tr)
        self.group = list(range(self.at + 1,
                                self.at + traffic["cycle_iterations"]))

    def cycle(self):
        """One cycle; returns its spans [(kind, start, end, iterations)]
        and its metrics dicts."""
        tr = self.trainer
        s = time.perf_counter()
        restore(tr, self.snap)
        first = tr.step(self.at)
        _sync(self.dev)
        e = time.perf_counter()
        ms = tr.step_group(self.group)
        _sync(self.dev)
        return ([("step", s, e, 1),
                 ("group", e, time.perf_counter(), len(self.group))],
                [first] + ms)

    def close(self):
        self.run.close()
        self.trainer = self.snap = None

    # -- the first cycle, spied --------------------------------------------
    def check_cycle(self, dtypes=(torch.float32,)):
        """The first cycle with the readings the reference judges (the
        cull's in each of `dtypes`)."""
        from reduced3dgs_torch.ops import redundancy
        from reduced3dgs_torch.train import trainer as T
        from reduced3dgs_torch.utils import profiling

        tr = self.trainer
        restore(tr, self.snap)
        seen = {}
        cull = CullSpy(self, tr, dtypes)
        with _spied(T, "prune_dead_step", _prune_spy(seen)), \
                _spied(redundancy, "knn_indices", _knn_spy(seen)), \
                _spied(T, "mercy_step", _mercy_spy(seen)), \
                _spied(tr.rows, "transmittance", cull, own=True), \
                profiling.enable():
            t0 = time.perf_counter()
            tr.step(self.at)
            _sync(self.dev)
            step_s = time.perf_counter() - t0
        # the event's counters (its stage clock holds the spies' work)
        seen["counters"] = profiling.snapshot()["counters"]
        profiling.reset()
        cull.finish()
        post = _post_state(tr.state)
        n = self.traffic["check_steps"]
        m1 = tr.step_group(self.group[:1])
        opt = tr.state.opt
        grads = {k: float(((getattr(opt.mu, k) - ref_train.B1 * post["mu"][k])
                           / (1 - ref_train.B1)).norm()) for k in LEAVES}
        ms = m1 + tr.step_group(self.group[1:n])
        params = tr.state.pool.params
        change = {k: float((getattr(params, k) - post["params"][k]).norm())
                  for k in LEAVES}
        tr.step_group(self.group[n:])
        _sync(self.dev)
        seen.update(cull=cull, post=post, step_s=step_s,
                    train=dict(losses=[float(m["loss"]) for m in ms],
                               grad_norms=grads, change_norms=change))
        return seen


@contextmanager
def _spied(owner, name, spy, own=False):
    """owner.name replaced by spy(real, *args, **kw) inside the block
    (own: set on an instance, the real one read from it)."""
    real = getattr(owner, name)

    def call(*a, **kw):
        return spy(real, *a, **kw)

    setattr(owner, name, call)
    try:
        yield
    finally:
        if own:
            delattr(owner, name)
        else:
            setattr(owner, name, real)


def _prune_spy(seen):
    def spy(real, state, *a, **kw):
        before = state.pool.alive.clone()
        opacity = state.pool.params.opacity[:, 0].clone()
        out = real(state, *a, **kw)
        seen["prune"] = (before, opacity, out[0].pool.alive.clone())
        return out
    return spy


def _knn_spy(seen):
    def spy(real, points, k, **kw):
        out = real(points, k, **kw)
        real_rows = int(torch.isfinite(points).all(1).sum())
        seen["knn"] = (points[:real_rows].clone(), out[:real_rows].clone())
        return out
    return spy


def _mercy_spy(seen):
    def spy(real, state, counts, **kw):
        pool = state.pool
        before = dict(xyz=pool.params.xyz.clone(),
                      scales=pool.get_scaling().clone(),
                      quats=pool.get_rotation().clone(),
                      opacity=pool.get_opacity()[:, 0].clone(),
                      alive=pool.alive.clone(), counts=counts.clone())
        out = real(state, counts, **kw)
        seen["mercy"] = (before, out[0].pool.alive.clone())
        return out
    return spy


def _post_state(state):
    """The state after the compression iteration: what the reference's
    training iterations start from."""
    pool, opt = state.pool, state.opt
    return dict(params={k: getattr(pool.params, k).clone() for k in LEAVES},
                mu={k: getattr(opt.mu, k).clone() for k in LEAVES},
                nu={k: getattr(opt.nu, k).clone() for k in LEAVES},
                steps={k: getattr(opt.step, k) for k in LEAVES},
                degrees=pool.degrees.clone(), alive=pool.alive.clone())


class CullSpy:
    """The trainer's transmittance renders, camera by camera: each
    render's per-primitive sums feed the reference's statistics at once
    (in each of `dtypes`: float32, and bfloat16 for the control); on the
    traffic's sampled cameras of the first pass the reference renders the
    same state and the sums are compared (trans_gap), and the reference's
    pair counts are kept for the roofline."""

    def __init__(self, drv: Compress, tr, dtypes=(torch.float32,)):
        self.cfg, self.dev, self.dtypes = drv.cfg, drv.dev, dtypes
        self.poses = scene.training_poses(drv.cfg, drv.seed)
        self.nc = len(self.poses)
        rng = np.random.default_rng([int(drv.seed), 6])
        self.sampled = sorted(rng.choice(self.nc, drv.traffic["count_samples"],
                                         replace=False).tolist())
        self.calls = 0
        self.gaps, self.control_gaps, self.counts = [], [], []
        self.lanes = None
        self.thresholds = (tr.opt_cfg.std_threshold,
                           tr.opt_cfg.cdist_threshold)

    def __call__(self, real, pool, features, cam, *, budget, backend):
        out = real(pool, features, cam, budget=budget, backend=backend)
        i, first_pass = self.calls % self.nc, self.calls < self.nc
        self.calls += 1
        with torch.no_grad(), full_precision():
            if self.lanes is None:
                self.alive = pool.alive.clone()
                self.leaves = {k: getattr(pool.params, k).clone()
                               for k in LEAVES}
                self.lanes = {dt: dict(
                    xyz=pool.params.xyz.to(dt, copy=True),
                    sh=features.to(dt, copy=True),
                    degrees=pool.degrees.clone(), acc=None)
                    for dt in self.dtypes}
            if first_pass and i in self.sampled:
                self._compare(i, out)
            centre = torch.as_tensor(np.asarray(self.poses[i][2],
                                                np.float32),
                                     device=self.dev)
            for dt, lane in self.lanes.items():
                if lane["acc"] is None:
                    lane["acc"] = ref.stats_start(lane["xyz"])
                lane["acc"] = ref.stats_add(
                    lane["acc"], lane["sh"], lane["xyz"], lane["degrees"],
                    (centre.to(dt), out[0], out[1].to(dt), out[2]))
            if first_pass and i == self.nc - 1:
                for dt, lane in self.lanes.items():
                    _, var, mean = ref.stats_result(lane["acc"])
                    if dt == torch.float32:  # how near each row's test is
                        self.std_margin = torch.nan_to_num(
                            torch.sqrt(var)).mean(1) - self.thresholds[0]
                    lane["sh"], lane["degrees"] = ref.variance_pass(
                        lane["sh"], lane["degrees"], self.alive, var, mean,
                        self.thresholds[0])
                    lane["acc"] = None
        return out

    def _render(self, i, dtype):
        leaves = {k: v.to(dtype) for k, v in self.leaves.items()}
        sh = torch.cat([leaves["features_dc"], leaves["features_rest"]], 1)
        cam = view_of(self.cfg, self.poses[i], self.dev, dtype)
        p = raster.project(leaves["xyz"], sh, leaves["scaling"],
                           leaves["rotation"], leaves["opacity"][:, 0],
                           self.lanes[self.dtypes[0]]["degrees"], self.alive,
                           cam)
        bins = raster.bin_tiles(p, cam.width, cam.height)
        t_sum, touched, pairs = ref.transmittance(p, bins, cam.width,
                                                  cam.height)
        return t_sum.float(), touched, raster.counts(p, bins, pairs)

    def _compare(self, i, out):
        def gap(t, c, t_ref, c_ref):
            return max(float((t - t_ref).abs().sum() / t_ref.abs().sum()),
                       float((c.long() - c_ref).abs().sum() / c_ref.sum()))

        t32, c32, counts = self._render(i, torch.float32)
        self.counts.append(counts)
        self.gaps.append(gap(out[1], out[2], t32, c32))
        if torch.bfloat16 in self.dtypes:
            t16, c16, _ = self._render(i, torch.bfloat16)
            self.control_gaps.append(gap(t16, c16, t32, c32))

    def finish(self):
        """The reference's distance pass: its degrees and coefficients
        (float32: sh, degrees; by dtype: results)."""
        self.results = {}
        thr = self.thresholds[1] * np.sqrt(3.0) / 255.0
        with torch.inference_mode(), full_precision():
            for dt, lane in self.lanes.items():
                dist, _, _ = ref.stats_result(lane["acc"])
                self.results[dt] = ref.distance_pass(
                    lane["sh"], lane["degrees"], self.alive, dist, thr)
                if dt == torch.float32:
                    self.margins = torch.stack(
                        [self.std_margin, torch.nan_to_num(dist[:, 2]) - thr,
                         torch.nan_to_num(dist[:, 1]) - thr], 1)
        self.sh, self.degrees = self.results[torch.float32]
        self.lanes = self.leaves = None


# -- the reference's readings ------------------------------------------------

def knn_mismatches(points, lists, seed, device, dtype=None):
    """Rows among KNN_QUERIES seeded rows whose neighbour list (a set)
    differs from the reference's brute force over all rows; dtype: the
    reference's own lists in that precision in place of the program's
    (the control)."""
    n = points.shape[0]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 62) + 7)
    rows = torch.randperm(n, generator=g, device=device)[:KNN_QUERIES]
    want = ref.knn(points, rows, lists.shape[1])
    got = (lists[rows].long() if dtype is None
           else ref.knn(points.to(dtype), rows, lists.shape[1]))
    same = (torch.sort(want, 1).values == torch.sort(got, 1).values).all(1)
    return int((~same).sum()), rows.numel()


def coefficient_gap(sh, degrees, want_sh, want_degrees, alive):
    """The largest |sh - want_sh| of the (N, 16, 3) coefficients after
    the cull, over the alive rows whose degree equals want_degrees' (the
    rows whose degree differs are cull_degree_mismatches'): the variance
    pass's weighted mean in the DC term and the bands either pass zeroes.
    0 where no row is compared."""
    rows = alive & (degrees.long() == want_degrees.long())
    if not bool(rows.any()):
        return 0.0
    return float((sh[rows].float() - want_sh[rows].float()).abs().max())


def reference_cameras(cfg, seed):
    """[(proj, inv_proj, width, height)] of the train cameras, the
    published matrices."""
    fx = np.radians(cfg["assumed"]["fov_x_deg"])
    fy = scene.fov_y(cfg)
    cams = []
    for R, T, _ in scene.training_poses(cfg, seed):
        _, proj = scene.matrices(R, T, fx, fy)
        inv = np.linalg.inv(proj.astype(np.float64)).astype(np.float32)
        cams.append((proj, inv))
    return cams


def mercy_decision(before, lists, cfg, seed, opt, device,
                   dtype=torch.float32):
    """The reference's (alive mask after mercy, redundancy (C,)) on the
    program's state before it, with the program's neighbour lists (over
    the alive rows, in row order), computed in `dtype`."""
    alive = before["alive"]
    rows = torch.nonzero(alive).flatten()
    cams = [(torch.as_tensor(p, device=device).to(dtype),
             torch.as_tensor(i, device=device).to(dtype), cfg["width"],
             cfg["height"]) for p, i in reference_cameras(cfg, seed)]
    red_alive = ref.redundancy(*(before[k][rows].to(dtype)
                                 for k in ("xyz", "scales", "quats")),
                               lists.long(), cams, opt.box_size)
    red = torch.zeros(alive.shape[0], dtype=torch.int64, device=device)
    red[rows] = red_alive
    return ref.mercy(alive, red, before["opacity"].to(dtype),
                     opt.lambda_mercy, opt.mercy_minimum), red


def mercy_mismatches(before, after, lists, cfg, seed, opt, device):
    """Rows whose alive bit after mercy differs from the reference's
    decision (mercy_decision), and the alive rows whose redundancy count
    differs from the program's."""
    want, red = mercy_decision(before, lists, cfg, seed, opt, device)
    rows = torch.nonzero(before["alive"]).flatten()
    counts_gap = int((red[rows] != before["counts"][rows].long()).sum())
    return int((want != after).sum()), counts_gap


def restore_mismatches(state, cfg, seed, traffic, device):
    """Rows where the state a cycle restores differs from the seeded
    state the harness makes (splatbench.generators.train.state_inputs):
    any leaf, Adam moment, alive bit or degree; every row if a leaf's
    step count is not the one before the traffic's first iteration."""
    leaves, mu, nu = state_inputs(cfg, seed, device)
    pool, opt = state.pool, state.opt
    bad = (pool.alive != leaves["alive"]) | (pool.degrees
                                             != leaves["degrees"])
    for k in LEAVES:
        for got, want in ((getattr(pool.params, k), leaves[k]),
                          (getattr(opt.mu, k), mu[k]),
                          (getattr(opt.nu, k), nu[k])):
            bad |= (got != want).reshape(got.shape[0], -1).any(1)
    if any(getattr(opt.step, k) != traffic["first_iteration"] - 1
           for k in LEAVES):
        return int(bad.numel())
    return int(bad.sum())


def train_readings(cfg, traffic, seed, post, device, dtype=torch.float32):
    """The reference's losses, first gradient norms and changes of the
    check iterations after the compression iteration, from the program's
    post-compression state; the cameras follow the compression
    iteration's in the trainer's order.  dtype: a lower precision (the
    control)."""
    poses = scene.training_poses(cfg, seed)
    order = camera_order(seed, len(poses))
    ext = extent(poses)
    params = {k: v.to(dtype, copy=True) for k, v in post["params"].items()}
    start = {k: v.clone() for k, v in params.items()}
    mu = {k: v.to(dtype, copy=True) for k, v in post["mu"].items()}
    nu = {k: v.to(dtype, copy=True) for k, v in post["nu"].items()}
    steps = dict(post["steps"])
    opt = cfg["training"]
    bg = torch.zeros(3, device=device, dtype=dtype)
    first = traffic["first_iteration"] + 1
    losses, g_norm = [], None
    for j in range(traffic["check_steps"]):
        i = int(order[1 + j])
        cam = view_of(cfg, poses[i], device, dtype)
        gt = scene.ground_truth(cfg, seed, i, device).to(dtype)
        loss, grads, _ = ref_train.loss_and_grads(
            params, post["degrees"], post["alive"], cam, gt, bg, opt)
        losses.append(float(loss))
        if g_norm is None:
            g_norm = {k: float(grads[k].float().norm()) for k in LEAVES}
        lrs = ref_train.learning_rates(first + j, ext, opt)
        params, mu, nu, steps = ref_train.adam(params, grads, mu, nu, steps,
                                               lrs)
        del grads
    change = {k: float((params[k].float() - start[k].float()).norm())
              for k in LEAVES}
    return dict(losses=losses, grad_norms=g_norm, change_norms=change)


def timed_window(drv: Compress, seconds: float, tracer=None,
                 traced_calls: int = 0):
    """Whole cycles until `seconds` have passed; returns (window seconds,
    iterations, spans, cycles, the window's start).  The first
    `traced_calls` cycles are traced, each a named host span."""
    spans = []
    done = cycles = 0
    _sync(drv.dev)
    traced = tracer is not None and tracer.enabled
    if traced:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        with (torch.profiler.record_function("splatbench.cycle")
              if traced else nullcontext()):
            sp, _ = drv.cycle()
        spans += sp
        cycles += 1
        done += sum(n for *_, n in sp)
        if traced and cycles == traced_calls:
            tracer.stop()
            traced = False
        e = sp[-1][2]
        if e - t0 >= seconds:
            break
    if traced:
        tracer.stop()
    return e - t0, done, spans, cycles, t0


def measure(cfg, traffic, seed: int, seconds: float, tracing: bool, device):
    """One run of a `compress` cell: set-up, the first cycle with its
    readings, the window, then the reference."""
    return run(cfg, traffic, seed, seconds, tracing, device)[0]


def run(cfg, traffic, seed: int, seconds: float, tracing: bool, device,
        dtypes=(torch.float32,)):
    """measure's Outcome, the first cycle's readings and the trainer's
    configuration (the cull's reference also in each of `dtypes`)."""
    from splatbench import judge
    from splatbench.profiling import Tracer
    from splatbench.record import Outcome

    drv = Compress(cfg, traffic, seed, device)
    prog = drv.check_cycle(dtypes)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(tracing, device)
    window_s, iters, spans, cycles, t0 = timed_window(
        drv, seconds, tracer, traffic["trace_calls"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tracer.read()
    tr = drv.trainer
    opt = tr.opt_cfg
    stats = dict(tr.stats)
    restore(tr, drv.snap)  # what every cycle starts from
    restored = restore_mismatches(tr.state, cfg, seed, traffic, device)
    cull = prog["cull"]
    notes = [f"window: {iters} iterations in {window_s:.3f} s, {cycles} "
             f"cycles of {traffic['cycle_iterations']}, budget {drv.budget}, "
             f"peak memory {peak} B",
             f"first cycle: compression iteration {prog['step_s']:.3f} s "
             f"(spied); after it {stats}; counters {event_counters(prog)}"]
    if tracer.summary is not None:
        notes.append(f"traced cycle: {traced_parts()}")
    drv.close()
    del drv, tr
    _free(device)
    numbers = {"restore_mismatches": restored}
    numbers["prune_mismatches"] = judge.prune_mismatches(prog["prune"])
    points, lists = prog["knn"]
    mercy_before, mercy_after = prog["mercy"]
    with full_precision():
        numbers["knn_mismatches"], n_q = knn_mismatches(points, lists, seed,
                                                        device)
        numbers["mercy_mismatches"], counts_gap = mercy_mismatches(
            mercy_before, mercy_after, lists, cfg, seed, opt, device)
    numbers["trans_gap"] = max(cull.gaps)
    degrees_after = prog["post"]["degrees"]
    numbers["cull_degree_mismatches"] = int(
        (degrees_after != cull.degrees.to(degrees_after.dtype)).sum())
    post_alive = prog["post"]["alive"]
    post_sh = torch.cat([prog["post"]["params"]["features_dc"],
                         prog["post"]["params"]["features_rest"]], 1)
    numbers["feature_gap"] = coefficient_gap(post_sh, degrees_after,
                                             cull.sh, cull.degrees,
                                             post_alive)
    del post_sh
    demoted = torch.bincount(degrees_after[post_alive].long(), minlength=4)
    differ = torch.nonzero(degrees_after != cull.degrees.to(
        degrees_after.dtype)).flatten()[:5]
    near = [(int(r), int(degrees_after[r]), int(cull.degrees[r]),
             [float(m) for m in cull.margins[r]]) for r in differ]
    with full_precision():
        ref_read = train_readings(cfg, traffic, seed, prog["post"], device)
    numbers.update({k: v for k, v in judge.train_numbers(
        prog["train"], ref_read).items()})
    notes += [
        f"mercy: {int(mercy_before['alive'].sum())} alive before, "
        f"{int(mercy_after.sum())} after; redundancy counts differing from "
        f"the reference's on the program's lists: {counts_gap}",
        f"kNN: {numbers['knn_mismatches']} of {n_q} sampled rows differ",
        f"cull: degrees 0..3 of the alive rows after it {demoted.tolist()}; "
        f"reference {torch.bincount(cull.degrees[post_alive].long(), minlength=4).tolist()}; "
        f"transmittance gaps "
        f"{cull.gaps} on cameras {cull.sampled}; rows whose degree differs "
        f"(row, program, reference, the reference's std, distance to "
        f"degree 2 and to degree 1 less their thresholds): {near}",
        f"program {json_line(prog['train'])}",
        f"reference {json_line(ref_read)}"]
    traced = traffic["trace_calls"]
    record = dict(kind="train", spans=spans, iterations=iters,
                  window_s=window_s, width=cfg["width"], height=cfg["height"],
                  traced_iterations=traced * traffic["cycle_iterations"],
                  traced_events=traced, traced_cull_renders=traced * 2
                  * cfg["train_cameras"], knn_rows=int(mercy_before[
                      "alive"].sum()), counts=cull.counts,
                  degree_counts=scene.degree_counts(cfg))
    out = Outcome(t0, {"train_ms_per_iter": 1e3 * window_s / iters},
                  record, numbers, iters, 0, peak, notes, tracer.summary)
    return out, prog, opt


COUNTED = ("mercy_pruned", "sh_demoted", "budget_redos", "knn_fallback_rows",
           "knn_certified_blocks", "knn_scanned_blocks")


def _counted(counters):
    """The sums of COUNTED and their keyed parts, budget_redos and
    knn_fallback_rows 0 where nothing was counted."""
    out = {"budget_redos": 0, "knn_fallback_rows": 0}
    out.update({k: v["sum"] for k, v in sorted(counters.items())
                if k.split(".")[0] in COUNTED})
    return out


def event_counters(prog):
    """The compression iteration's program counters."""
    return _counted(prog["counters"])


def traced_parts():
    """The traced cycle's stage milliseconds by name and its counters, as
    the program recorded them (None on a program without them)."""
    from splatbench.program_trace import snapshot as program_snapshot

    snap = program_snapshot()
    if snap is None:
        return None
    return {"stages_ms": {k: 1e3 * v["s"] for k, v in snap["stages"].items()},
            "counts": {k: v["count"] for k, v in snap["stages"].items()},
            "counters": _counted(snap["counters"])}


def _free(device):
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
