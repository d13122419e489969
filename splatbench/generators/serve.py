"""The `serve` traffic: the `view` traffic's viewer (one viewer in a closed
loop, each request one frame at the next pose of the seeded path), its
frames served by the program's own frame entry, render.py's FrameServer:
per request the harness hands it the pose's row of pinned host memory,
and FrameServer.frame copies it into its device vector, replays its
captured frame, reads num_rendered once on the host and, where the frame
does not fit, climbs the budget ladder, captures again and renders
again.  All of it counts in the frame's latency.

Loading, the path, the budget settled over a sample of it, the reference
frames, the checks and the record (of kind "view", so the view cells'
readers read it) are the `view` generator's.  Set-up ends with one warm
frame, which captures the FrameServer's graph.  A program without
FrameServer cannot run this traffic: the run stops at set-up.
"""

from __future__ import annotations

import numpy as np
import torch

from splatbench import scene
from splatbench.generators import view as vw


class Serve(vw.View):
    """The view cell's viewer with the program's FrameServer in place of
    the frame that the `view` generator composes."""

    def _capture(self):
        from reduced3dgs_torch.render import FrameServer

        self.server = FrameServer(self.pv, self.cfg["width"],
                                  self.cfg["height"], self.bg, self.budget)
        self.server.frame(self.host[0])  # the warm frame: the capture
        return self.server.runner

    def frame(self, keep: bool = False):
        """One request: the next pose's frame; returns its pose index.
        keep: a copy of the frame is kept for the check."""
        i = self.next_pose
        self.next_pose = (i + 1) % len(self.poses)
        out = self.server.frame(self.host[i])
        self.budget = self.server.budget
        if keep:
            self.kept[i] = out.color.clone()
        return i

    def close(self):
        self.server = None
        super().close()


def measure(cfg, traffic, seed: int, seconds: float, tracing: bool, device):
    """One run of a `serve` cell: set-up, the window, then the reference
    frames of the kept poses and, when traced, the pair counts."""
    # a program without the frame entry stops here, before any set-up
    from reduced3dgs_torch.render import FrameServer  # noqa: F401
    from splatbench import judge
    from splatbench.profiling import Tracer
    from splatbench.record import Outcome
    from splatbench.reference import full_precision

    drv = Serve(cfg, traffic, seed, device)
    settled = drv.budget
    rng = np.random.default_rng([int(seed), 6])
    keep = sorted(rng.choice(traffic["check_from"], traffic["check_frames"],
                             replace=False).tolist())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(tracing, device)
    window_s, frames, lat, t0 = vw.timed_window(
        drv, seconds, keep, tracer, traffic["trace_frames"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tracer.read()
    notes = [f"window: {frames} frames in {window_s:.3f} s, budget "
             f"{settled} -> {drv.budget} (the redos: budget_redos, traced), "
             f"median frame "
             f"{1e3 * sorted(lat)[len(lat) // 2]:.4f} ms"]
    kept, poses = drv.kept, drv.poses
    rows = None
    if drv.stored is not None:
        rows = {k: v.clone() for k, v in drv.pool_rows().items()}
    drv.close()
    del drv
    missing = [i for i in keep if i not in kept]
    with full_precision():
        model = vw.reference_model(cfg, seed, device)
        numbers = {}
        if rows is not None:
            numbers["pool_gap"] = judge.pool_mismatch(rows, model)
            del rows
        refs, pads = {}, []
        for i in keep:
            if i in kept:
                refs[i], pad = vw.reference_frame(cfg, model, poses[i],
                                                  device)
                pads.append(pad)
        notes.append(f"pad need over the slack pool of the kept frames: "
                     f"{pads}")
        if missing or not refs:
            numbers["frames_missing"] = float(len(missing) or len(keep))
        if refs:
            numbers.update(judge.frame_numbers(kept, refs))
        record = dict(kind="view", frames=frames, window_s=window_s,
                      width=cfg["width"], height=cfg["height"],
                      degree_counts=scene.degree_counts(cfg),
                      traced_frames=min(frames, traffic["trace_frames"]))
        if tracer.summary is not None:
            pick = rng.choice(record["traced_frames"],
                              traffic["count_samples"],
                              replace=False).tolist()
            record["counts"] = [vw.reference_frame(
                cfg, model, poses[i], device, count_pairs=True)[1]
                for i in pick]
            notes.append(f"reference counts of poses {pick}: "
                         f"{record['counts']}")
    return Outcome(t0, {"render_fps": frames / window_s,
                        "frame_ms_p95": 1e3 * vw.p95(lat)},
                   record, numbers, frames, 0, peak, notes, tracer.summary)
