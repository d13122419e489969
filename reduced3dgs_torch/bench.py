"""Headline benchmark of the port: rasterizer fwd+bwd throughput on one
card, the counterpart of root bench.py.

    python -m reduced3dgs_torch.bench [--configs 1080p 720p 512p] \\
        [--device cpu]

Prints one JSON line per configuration, headline (1080p) first, each
flushed as soon as it is measured, with root bench.py's keys ("metric",
"value", "unit", "vs_baseline", "num_rendered", "instances_per_s") and a
"device" key (nvidia-smi's name and power limit, or "cpu").  Each
configuration runs in its own subprocess, with one retry.

The step is root bench.py's: one differentiable render of its synthetic
scene (the same numpy draws from default_rng(0), SH degree 3, the camera
at (0, 0, -3.6)) with the bf16x2 gradient reduction, the L1 loss against
a zero target and the gradients of the five parameter leaves.  On the
card the step is captured once as a CUDA graph and replayed ITERS times
per timed window, best of WINDOWS windows: root's jitted fori_loop of 20
steps, best of 4.  On the CPU the same step runs eagerly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from argparse import ArgumentParser

import numpy as np

# root bench.py's estimate of the reference CUDA implementation's fwd+bwd
# throughput on its README hardware (an A6000: 1080p at ~15 ms per
# iteration); an estimate with roughly +-40 % error bars, not a
# measurement
REF_PIXELS_PER_S = 1.4e8
# (width, height, primitives, splat scale range, instance budget, tag):
# root bench.py's CONFIGS, headline first
CONFIGS = [
    (1920, 1080, 1 << 19, (0.00432, 0.0189), 1 << 22, "1080p"),
    (1280, 720, 1 << 19, (0.00392, 0.01715), 1 << 21, "720p"),
    (512, 512, 1 << 17, (0.008, 0.040), 3 << 18, "512p"),
]
ITERS = 20  # steps per timed window
WINDOWS = 4  # timed windows; the best one counts
CHILD_TIMEOUT_S = 900
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_arrays(n, smin, smax):
    """Root bench.py's scene: (xyz, features, scales, rotations, opacity,
    degrees) numpy arrays, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, 0] = rng.uniform(-1.5, 1.5, (n, 3))
    feats[:, 1:] = rng.normal(0, 0.2, (n, 15, 3)).astype(np.float32)
    scales = np.log(rng.uniform(smin, smax, (n, 3))).astype(np.float32)
    rots = rng.normal(0, 1, (n, 4)).astype(np.float32)
    opac = rng.uniform(-2, 3, n).astype(np.float32)
    degrees = np.full(n, 3, np.int32)
    return xyz, feats, scales, rots, opac, degrees


class FwdBwd:
    """Root bench.py's step on `device` at one configuration.

    ``leaves`` are the five parameter tensors (requires_grad),
    ``step()`` renders a view from each camera eye of `eyes` (root's
    one, by default) with the `grad_reduce` reduction, takes the L1 loss
    averaged over the views and its gradients and returns (loss, each
    view's num_rendered, the five gradients), all tensors.  `chained`
    makes it root profile_trace.py's
    step: the render reads xyz + 1e-30 * ``carry``, the last step's loss
    (``carry.zero_()`` starts a new chain), so the steps form one chain."""

    def __init__(self, width, height, n, smin, smax, budget, device,
                 grad_reduce="bf16x2", chained=False,
                 eyes=((0, 0, -3.6),)):
        import torch

        from reduced3dgs_torch.cameras import Camera

        arrs = bench_arrays(n, smin, smax)
        self.leaves = [torch.as_tensor(a, device=device).requires_grad_(True)
                       for a in arrs[:5]]
        self.degrees = torch.as_tensor(arrs[5], device=device)
        self.cams = [Camera.look_at(eye=eye, target=(0, 0, 0), width=width,
                                    height=height).params(device)
                     for eye in eyes]
        self.background = torch.zeros(3, device=device)
        self.target = torch.zeros((height, width, 3), device=device)
        self.width, self.height, self.budget = width, height, budget
        self.device = torch.device(device)
        self.grad_reduce = grad_reduce
        self.carry = torch.zeros((), device=device) if chained else None

    def step(self):
        import torch

        from reduced3dgs_torch.renderer import render

        leaves = list(self.leaves)
        if self.carry is not None:
            leaves[0] = leaves[0] + 1e-30 * self.carry
        losses, rendered = [], []
        for cam in self.cams:
            out = render(*leaves, self.degrees, cam, self.background,
                         width=self.width, height=self.height,
                         instance_budget=self.budget,
                         grad_reduce=self.grad_reduce)
            losses.append((out.color - self.target).abs().mean())
            rendered.append(out.num_rendered)
        loss = sum(losses) / len(losses)
        grads = torch.autograd.grad(loss, self.leaves)
        loss = loss.detach()
        if self.carry is not None:
            self.carry.copy_(loss)
        return loss, torch.stack(rendered), grads

    def runner(self):
        """The step as a replayable runner (graphs.py): a CUDA graph on
        the card, warmed up by two eager steps; eager on the CPU."""
        from reduced3dgs_torch import graphs

        return graphs.runner(self.step, self.device, warmup=2)


def measure(width, height, n, smin, smax, budget, device):
    """Root bench.py's _measure on the port: returns (pixels/s, the
    step's num_rendered, seconds per step of the best window)."""
    from reduced3dgs_torch.graphs import time_replays

    run = FwdBwd(width, height, n, smin, smax, budget, device).runner()
    best = min(time_replays(run, ITERS, device) for _ in range(WINDOWS))
    nr = int(run.out[1])
    return width * height * ITERS / best, nr, best / ITERS


def device_name(device) -> str:
    """nvidia-smi's "name, power.limit" of the card, or "cpu"."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def child_result(config, device):
    """What a configuration's child process prints: pixels/s,
    num_rendered, seconds per step and the device's name."""
    width, height, n, (smin, smax), budget, _ = config
    pps, nr, step_s = measure(width, height, n, smin, smax, budget, device)
    return {"pixels_per_s": pps, "num_rendered": nr, "step_s": step_s,
            "device": device_name(device)}


def result_line(tag, data):
    """Root bench.py's JSON line (and the device) from a child's
    result."""
    pps, nr = data["pixels_per_s"], data["num_rendered"]
    return {
        "metric": f"raster_fwd_bwd_{tag}",
        "value": round(pps, 1),
        "unit": "pixels/s/chip",
        "vs_baseline": round(pps / REF_PIXELS_PER_S, 4),
        "num_rendered": nr,
        "instances_per_s": round(nr / data["step_s"], 1),
        "device": data["device"],
    }


def run_config(config, device: str, timeout: float = CHILD_TIMEOUT_S):
    """One configuration in a child process, with one retry; prints and
    returns its JSON line (a dict), or None if both attempts failed."""
    spec = ",".join(str(v) for v in (*config[:3], *config[3], config[4]))
    for _ in range(2):
        try:
            r = subprocess.run(
                [sys.executable, "-m", "reduced3dgs_torch.bench", "--child",
                 spec, "--device", device], cwd=_ROOT, capture_output=True,
                text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            continue
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode != 0 or not lines:
            sys.stderr.write(r.stderr[-4000:])
            continue
        line = result_line(config[-1], json.loads(lines[-1]))
        print(json.dumps(line), flush=True)
        return line
    return None


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    tags = [c[-1] for c in CONFIGS]
    parser.add_argument("--configs", nargs="+", default=tags, choices=tags)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain PyTorch "
                             "versions of the kernels)")
    parser.add_argument("--child", default=None,
                        help="width,height,primitives,smin,smax,budget: "
                             "measure this one configuration here")
    args = parser.parse_args(argv)

    from reduced3dgs_torch.device import resolve

    device = resolve(args.device)
    if args.child:
        w, h, n, smin, smax, budget = args.child.split(",")
        config = (int(w), int(h), int(n), (float(smin), float(smax)),
                  int(budget), "child")
        print(json.dumps(child_result(config, device)), flush=True)
        return 0
    results = [run_config(c, args.device) for c in CONFIGS
               if c[-1] in args.configs]
    if not any(results):
        print(json.dumps({
            "metric": f"raster_fwd_bwd_{args.configs[0]}", "value": 0.0,
            "unit": "pixels/s/chip", "vs_baseline": 0.0}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
