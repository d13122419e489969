"""Per-component times of the render's fwd+bwd path on one card: the
port's counterpart of root profile_components.py.

    python -m reduced3dgs_torch.profile_components [width height n_prims
        budget] [--device cpu]

Root's scene and step (bench.FwdBwd: its default_rng(0) draws, scales
0.004-0.02, SH degree 3, the camera at (0, 0, -3.6), a zero target).  Four
stages, each one graphs.runner callable (a CUDA graph on the card, the
counterpart of one jitted call; eager on the CPU), timed as the mean of
REPS replays after the warm-up: preprocess; prep + binning; the full
forward (the image and num_rendered); the fwd+bwd step (the L1 mean, the
gradients of the five leaves, the render's default f32 reduction, so K5
runs).  Printed: the card's name and power limit, then root's lines and
differences.
"""

from __future__ import annotations

import argparse
import sys

from reduced3dgs_torch.bench import FwdBwd

DEFAULTS = (512, 512, 1 << 17, 1 << 20)  # width height n_prims budget
SCALES = (0.004, 0.02)
REPS = 10
STAGES = ("preprocess", "binning", "forward", "step")


class Components(FwdBwd):
    """Root's four jitted calls on `device`: ``preprocess()``,
    ``binning()``, ``forward()`` -> (image, num_rendered) and bench's
    ``step()`` with the f32 reduction -> (loss, num_rendered, the five
    gradients)."""

    def __init__(self, width, height, n, budget, device):
        super().__init__(width, height, n, *SCALES, budget, device,
                         grad_reduce="f32")

    def _prep(self):
        from reduced3dgs_torch.ops.preprocess import preprocess

        xyz, feats, scales, rots, opac = self.leaves
        return preprocess(xyz, scales, rots, opac, feats, self.degrees,
                          self.cam)

    def preprocess(self):
        import torch

        with torch.no_grad():
            return self._prep()

    def binning(self):
        import torch

        from reduced3dgs_torch.ops.binning import bin_gaussians

        with torch.no_grad():
            return bin_gaussians(self._prep(), self.width, self.height,
                                 self.budget)

    def forward(self):
        import torch

        from reduced3dgs_torch.renderer import render

        with torch.no_grad():
            out = render(*self.leaves, self.degrees, self.cam,
                         self.background, width=self.width,
                         height=self.height, instance_budget=self.budget)
        return out.color, out.num_rendered


def measure(width, height, n, budget, device):
    """{stage: ms per call} (the mean of REPS replays after the warm-up)
    and the forward's num_rendered."""
    from reduced3dgs_torch import graphs

    comp = Components(width, height, n, budget, device)
    ms, nr = {}, None
    for stage in STAGES:
        run = graphs.runner(getattr(comp, stage), device)
        run.replay()
        ms[stage] = graphs.time_replays(run, REPS, device) / REPS * 1e3
        if stage == "forward":
            nr = int(run.out[1])
        del run
    return ms, nr


def main(argv=None):
    from reduced3dgs_torch.bench import device_name
    from reduced3dgs_torch.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help="width height n_prims budget")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card by default")
    args = ap.parse_args(argv)
    width, height, n, budget = (list(args.sizes[:4])
                                + list(DEFAULTS[len(args.sizes[:4]):]))
    dev = resolve(args.device)
    print(device_name(dev), flush=True)
    print(f"config {width}x{height} n={n} budget={budget}", flush=True)
    ms, nr = measure(width, height, n, budget, dev)
    t_prep, t_bin, t_fwd, t_step = (ms[s] for s in STAGES)
    print(f"preprocess        {t_prep:8.2f} ms", flush=True)
    print(f"prep+binning      {t_bin:8.2f} ms  (binning ~"
          f"{t_bin - t_prep:.2f})", flush=True)
    print(f"full forward      {t_fwd:8.2f} ms  (fwd ~{t_fwd - t_bin:.2f})"
          f"  num_rendered={nr} (trunc={nr > budget})", flush=True)
    print(f"fwd+bwd step      {t_step:8.2f} ms  (bwd ~"
          f"{t_step - t_fwd:.2f})", flush=True)
    print(f"throughput        {width * height / (t_step / 1e3):,.0f} px/s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
