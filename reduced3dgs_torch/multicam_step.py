"""A k-camera batched training step on one card: the port's counterpart of
experiments/multicam_step.py.

    python -m reduced3dgs_torch.multicam_step [width height n budget iters]
        [--device cpu]

The reference trains one random camera per step.  A k-camera step
renders k views in one differentiated graph and applies ONE combined
update; per-camera work (preprocess, binning, K1-K3, the reduction)
scales with k, so what the batch amortizes is the step-level tail (the
update over every parameter) and the launch.

Root's scene (bench.py's draws from default_rng(0) at its 1080p scales,
SH degree 3 on every row), its cameras at eye (0.2 i, 0, -3.6) looking
at the origin, a zero target and a zero background, at root's defaults
(1920x1080, n = 2^19, budget 2^22, 10 iterations).  For k in (1, 2) the
step is bench.FwdBwd's over the k eyes: for each view renderer.render
(ops/preprocess.preprocess, ops/binning.bin_gaussians (K1) and
ops/tile_render.tile_render(grad_reduce="bf16x2") (K2; its autograd
Function's backward K3 and K6)), the L1 loss against the target
averaged over the k views, the five gradients by autograd; then root's
update in place, without bias correction as root's:
m = 0.9 m + 0.1 g, v = 0.999 v + 0.001 g^2, p -= 1e-4 m / (sqrt(v) +
1e-8) (not train/adam.py).

The step is captured as one CUDA graph (graphs.runner; eager on the
CPU), and its first replay must equal an eager step from the same state
bit for bit, or the run raises.  It is then replayed `iters` times in
one window timed by CUDA events, best of 3 windows, each window starting
from the same parameters and zeroed m and v, as each of root's three
salted runs does.  Root's salting (xyz + salt 1e-30 i) and host
read-back are not copied: they defeat XLA's caching and the TPU
runtime's lazy results, and a replayed CUDA graph recomputes every
replay.

Printed: root's three lines (ms per step and per camera for k = 1 and
2, the per-camera amortization), and per k each view's num_rendered
(root never checks its fixed budget: the line says whether a view
overflowed it), the peak memory (torch.cuda.max_memory_allocated), the
kernels' launches per replayed step and the unrounded ms per step.
"""

from __future__ import annotations

import argparse
import sys

from reduced3dgs_torch.bench import CONFIGS, FwdBwd

WIDTH, HEIGHT, N, BUDGET, ITERS = 1920, 1080, 1 << 19, 1 << 22, 10
SCALES = CONFIGS[0][3]  # bench's 1080p splat scale range
KS = (1, 2)
WINDOWS = 3


def update(params, grads, m, v):
    """Root's combined update, in place on params, m and v."""
    import torch

    with torch.no_grad():
        for p, g, mm, vv in zip(params, grads, m, v):
            mm.copy_(0.9 * mm + 0.1 * g)
            vv.copy_(0.999 * vv + 0.001 * g * g)
            p.copy_(p - 1e-4 * mm / (torch.sqrt(vv) + 1e-8))


class MultiCam(FwdBwd):
    """Root's k-view step on `device`: bench's step over root's k camera
    eyes with root's update after it.  ``leaves`` are the five parameter
    tensors (xyz, features, scales, rotations, opacity), ``m`` and ``v``
    the update's moments; ``step()`` takes one step in place and returns
    (loss, each view's num_rendered, the five gradients), all tensors;
    ``reset()`` restores the drawn parameters and zeroes m and v."""

    def __init__(self, k, width, height, n, budget, device):
        import torch

        super().__init__(width, height, n, *SCALES, budget, device,
                         eyes=[(0.2 * i, 0, -3.6) for i in range(k)])
        self.init = [t.detach().clone() for t in self.leaves]
        self.m = [torch.zeros_like(a) for a in self.init]
        self.v = [torch.zeros_like(a) for a in self.init]

    def reset(self):
        import torch

        with torch.no_grad():
            for p, a in zip(self.leaves, self.init):
                p.copy_(a)
        for t in self.m + self.v:
            t.zero_()

    def step(self):
        loss, rendered, grads = super().step()
        update(self.leaves, grads, self.m, self.v)
        return loss, rendered, grads

    def state(self):
        """Copies of the leaves and moments."""
        return [t.detach().clone() for t in self.leaves + self.m + self.v]


def graphed_equals_eager(sim, run):
    """One eager step and the graph's first replay, each from the reset
    state: True if the loss, num_rendered, gradients, parameters and
    moments agree bit for bit."""
    import torch

    sim.reset()
    loss, rendered, grads = sim.step()
    eager = [loss, rendered, *grads, *sim.state()]
    eager = [t.clone() for t in eager]
    sim.reset()
    run.replay()
    loss, rendered, grads = run.out
    graphed = [loss, rendered, *grads, *sim.state()]
    return all(torch.equal(a, b) for a, b in zip(eager, graphed))


def measure(k, width, height, n, budget, iters, device, printer=print):
    """Seconds per step of the best window for k views; prints the
    views' num_rendered, the peak memory, the launches per replay and
    the check of the graph against the eager step."""
    import torch

    from reduced3dgs_torch import graphs

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sim = MultiCam(k, width, height, n, budget, device)
    run = sim.runner()
    if not graphed_equals_eager(sim, run):
        raise RuntimeError(f"k={k}: the graphed step differs from the "
                           "eager step")
    best = float("inf")
    for _ in range(WINDOWS):
        sim.reset()
        best = min(best, graphs.time_replays(run, iters, device) / iters)
    rendered = [int(v) for v in run.out[1]]
    over = [i for i, v in enumerate(rendered) if v > budget]
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
            if on_card else "not measured (cpu)")
    fit = f"views {over} overflowed it" if over else "no view overflowed it"
    printer(f"k={k}: num_rendered per view {rendered} (budget {budget}: "
            f"{fit}); peak memory {peak}; graphed step bit for bit the "
            f"eager step; launches per replayed step {run.launches}; "
            f"{best * 1e3:.4f} ms/step over windows of {iters} replays")
    return best


def main(argv=None):
    from reduced3dgs_torch.bench import device_name
    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import log_launches_at_exit

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", type=int, nargs="*",
                    help="width height n budget iters (root's order; "
                         "missing ones take root's defaults)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    args = ap.parse_args(argv)
    defaults = [WIDTH, HEIGHT, N, BUDGET, ITERS]
    width, height, n, budget, iters = (
        args.sizes[:5] + defaults[len(args.sizes[:5]):])
    dev = resolve(args.device)
    log_launches_at_exit("multicam_step")
    print(device_name(dev), flush=True)
    results = {}
    for k in KS:
        best = measure(k, width, height, n, budget, iters, dev,
                       printer=lambda s: print(s, flush=True))
        results[k] = best
        print(f"k={k}: {best * 1e3:.1f} ms/step "
              f"({best * 1e3 / k:.1f} ms/camera)", flush=True)
    amort = results[1] - results[2] / 2
    print(f"per-camera amortization from 2-view batching: "
          f"{amort * 1e3:.1f} ms ({100 * amort / results[1]:.1f}% of a "
          f"1-camera step)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
