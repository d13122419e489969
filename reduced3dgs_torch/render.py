"""Rendering / FPS CLI of the port — counterpart of the root render.py.

    python -m reduced3dgs_torch.render -m <model_dir> \\
        [--models baseline quantised_half quantised_pack] \\
        [--variable_sh_bands] [--trace] [--device cpu]

Loads a trained model directory (self-describing via cfg_args), renders
the train/test splits of each requested variant into
``<split>/<variant>/ours_<iter>/{renders,gt}/NNNNN.png``, and measures
FPS as root render.py does (the first 50 test, else train, views of one
resolution, repeated to at least 32 frames, timed in one window), writing
``fps_results.json``:

  baseline        point_cloud.ply
  quantised       point_cloud_quantised.ply
  quantised_half  point_cloud_quantised_half.ply
  quantised_pack  point_cloud_quantised_pack.ply (u16c xyz codec)

--trace turns utils/profiling.py on for the whole run and adds its
snapshot under "trace" (the stage clock's seconds per stage, the host
spans and the counters: the binning's pad need against its slack pool,
budget redos, graph captures).

The instance budget climbs the {2^k, 3*2^(k-1)} ladder until the views'
true instance counts fit (renderer.fit); the FPS ring then renders
every view at one budget, on the card as a replayed CUDA graph of all
its frames.
--variable_sh_bands reorders each loaded pool by SH degree once and
shades from one packed coefficient block per band
(models/variable_sh.py); the colours enter the renderer as
color_precomp.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from reduced3dgs_torch.cameras import (
    CAMERA_VEC, camera_from_vector, camera_vector,
)
# next_budget: the ladder is renderer's; importable from here as before
from reduced3dgs_torch.renderer import fit, next_budget, render  # noqa: F401
from reduced3dgs_torch.utils import profiling

MODELS_CONFIG = {
    "baseline": {"quantised": False, "half_float": False},
    "quantised": {"quantised": True, "half_float": False},
    "quantised_half": {"quantised": True, "half_float": True},
    "quantised_pack": {"quantised": False, "half_float": False,
                       "pack_xyz": True},
}
FPS_START_BUDGET = 1 << 15
FPS_MIN_FRAMES = 32  # the views repeat to at least this many timed frames
VIEW_START_BUDGET = 1 << 19


class PoolView:
    """A pool's render inputs, gathered once (features concatenated).
    variable_sh: the pool is reordered by SH degree and shaded per view
    from its ragged blocks; the dense (P, 16, 3) features are not kept."""

    def __init__(self, pool, variable_sh: bool = False):
        self.ragged = None
        if variable_sh:
            from reduced3dgs_torch.models.variable_sh import build_ragged

            pool, self.ragged = build_ragged(pool)
        self.xyz = pool.params.xyz
        self.features = (pool.features() if self.ragged is None else
                         torch.zeros((pool.capacity, 1, 3),
                                     dtype=torch.float32,
                                     device=pool.device))
        self.scaling = pool.params.scaling
        self.rotation = pool.params.rotation
        self.opacity = pool.params.opacity[:, 0].contiguous()
        self.degrees = pool.degrees
        self.alive = pool.alive
        self.device = pool.device


def render_once(pv: PoolView, cp, background, budget: int,
                backend: str = "tile"):
    """Render one view given its CameraParams on the pool's device: one
    frame of profiling.VIEW_STAGES ("shade" for a ragged pool only), then
    its end."""
    with torch.inference_mode():
        color_precomp = None
        if pv.ragged is not None:
            from reduced3dgs_torch.models.variable_sh import eval_colors

            profiling.stage("shade", pv.device)
            color_precomp = eval_colors(pv.ragged, pv.xyz, cp.campos)
        profiling.stage("preprocess", pv.device)
        out = render(
            pv.xyz, pv.features, pv.scaling, pv.rotation, pv.opacity,
            pv.degrees, cp, background, width=cp.width, height=cp.height,
            instance_budget=budget, alive_mask=pv.alive, backend=backend,
            color_precomp=color_precomp)
        profiling.stage(profiling.END, pv.device)
        return out


def render_view(pv: PoolView, cam, background, budget: int = VIEW_START_BUDGET,
                backend: str = "tile"):
    """Render one view eagerly, redoing it up the budget ladder until it
    fits: its true instance count within the budget and its instances
    with their alignment pads within the binning's slots (renderer.py
    reports either miss as num_rendered > budget; renderer.fit redoes
    the frame).  Returns (RenderOut, budget used)."""
    cp = cam.params(pv.device)

    def attempt(b):
        out = render_once(pv, cp, background, b, backend)
        return out, int(out.num_rendered)

    return fit(attempt, budget)


def render_set(pv: PoolView, cams, background, out_dir: str,
               backend: str = "tile"):
    """Write renders/NNNNN.png (and gt/ where the camera has an image),
    through data/png.py (no Pillow needed): the path's frames served by a
    FrameServer, a new one where the image size changes."""
    from reduced3dgs_torch.data.png import write_png

    os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "gt"), exist_ok=True)
    server = None
    for idx, cam in enumerate(cams):
        if server is None or (server.width, server.height) != (cam.width,
                                                               cam.height):
            server = FrameServer(
                pv, cam.width, cam.height, background,
                VIEW_START_BUDGET if server is None else server.budget,
                backend=backend)
        out = server.frame(camera_vector(cam))
        img = np.clip(out.color.cpu().numpy(), 0, 1)
        write_png(os.path.join(out_dir, "renders", f"{idx:05d}.png"),
                  (img * 255).astype(np.uint8))
        if cam.image is not None:
            write_png(os.path.join(out_dir, "gt", f"{idx:05d}.png"),
                      (np.clip(cam.image, 0, 1) * 255).astype(np.uint8))


@profiling.spanned("r3dgs.render.settle_budget")
def settle_budget(pv: PoolView, cps, background, budget: int,
                  backend: str = "tile"):
    """The eager warm-up pass of the FPS ring: render every view at
    `budget`, climbing the ladder and starting over whenever a view
    needs more (more instances than the budget, or instances and
    alignment pads past the binning's slots: both reported as
    num_rendered > budget; renderer.fit redoes it, counted in
    budget_redos).  Returns (budget, the largest report)."""
    def attempt(b):
        needed = max(int(render_once(pv, cp, background, b,
                                     backend).num_rendered) for cp in cps)
        return needed, needed

    needed, budget = fit(attempt, budget)
    return budget, needed


class FrameServer:
    """One viewer's frame entry: render_once at a settled budget, captured
    once (graphs.runner: a CUDA graph on a card, a loop on the CPU) and
    reading its camera from a device vector (cameras.camera_vector's
    layout), so that a request costs one pose copy, one replay and one
    host read of num_rendered.

    ``settle(cams)`` settles the budget over the cameras as settle_budget
    does and captures the frame.  ``frame(pose)`` renders one request: the
    pose row (37 float32; pinned host memory keeps its copy off the
    host's clock) copied into the vector, the replay, the read; a frame
    that does not fit (renderer.py's report) is redone by renderer.fit:
    up the ladder, captured again and rendered again, each redo counted in
    budget_redos.  It returns the frame's RenderOut, the graph's outputs,
    which the next frame rewrites.  Spans r3dgs.serve.frame and, inside
    it, .replay / .read (the read waits for the card) / .recapture."""

    def __init__(self, pv: PoolView, width: int, height: int, background,
                 budget: int = VIEW_START_BUDGET, backend: str = "tile"):
        self.pv = pv
        self.width, self.height = width, height
        self.background = background
        self.budget = budget
        self.backend = backend
        self.vec = torch.zeros(CAMERA_VEC, dtype=torch.float32,
                               device=pv.device)
        self.runner = None

    def settle(self, cams):
        """Settle the budget over `cams` (Cameras of this size) and
        capture the frame at it; returns the budget."""
        cps = [c.params(self.pv.device) for c in cams]
        self.budget, _ = settle_budget(self.pv, cps, self.background,
                                       self.budget, self.backend)
        self.vec.copy_(torch.as_tensor(camera_vector(cams[0])))
        self._capture()
        return self.budget

    def _capture(self):
        from reduced3dgs_torch import graphs

        cp = camera_from_vector(self.vec, self.width, self.height)
        budget = self.budget
        self.runner = None  # the old graph's memory goes before the new
        self.runner = graphs.runner(
            lambda: render_once(self.pv, cp, self.background, budget,
                                self.backend), self.pv.device)

    def frame(self, pose):
        """The frame at `pose` (a camera vector, host tensor or array)."""
        with profiling.span("r3dgs.serve.frame"):
            self.vec.copy_(torch.as_tensor(pose), non_blocking=True)
            if self.runner is None:
                with profiling.span("r3dgs.serve.recapture"):
                    self._capture()
            return fit(self._attempt, self.budget)[0]

    def _attempt(self, budget):
        """fit's attempt: a recapture at a new budget, replay, read."""
        if budget != self.budget:
            self.budget = budget
            with profiling.span("r3dgs.serve.recapture"):
                self._capture()
        with profiling.span("r3dgs.serve.replay"):
            self.runner.replay()
        with profiling.span("r3dgs.serve.read"):
            return self.runner.out, int(self.runner.out.num_rendered)


def fps_ring(pv: PoolView, cps, background, budget: int,
             backend: str = "tile"):
    """The ring's frames, one render_once per view at one budget, as a
    replayable runner (graphs.py): on the card the n_views frames
    captured in one CUDA graph (the counterpart of root render.py's
    lax.scan over the stacked views in one launch), on the CPU the same
    frames eagerly.  ``runner.out`` holds the views' RenderOuts."""
    from reduced3dgs_torch import graphs

    def frames():
        return [render_once(pv, cp, background, budget, backend)
                for cp in cps]

    return graphs.runner(frames, pv.device)


def measure_fps(pv: PoolView, cams, background, backend: str = "tile",
                budget: int = FPS_START_BUDGET):
    """Root render.py's FPS: the views (one resolution) repeated to at
    least FPS_MIN_FRAMES frames, one budget for all of them settled by
    the eager ladder, then one timed window of n_views * reps frames with
    no host read inside it: the graphed ring replayed reps times on the
    card (CUDA events around the window), the same frames eagerly on the
    CPU (host clock).  Returns fps, the budget, frames, reps, capture_s,
    the launches of each kernel per replay and the largest instance
    count."""
    from reduced3dgs_torch.graphs import time_replays

    cps = [c.params(pv.device) for c in cams]
    budget, needed = settle_budget(pv, cps, background, budget, backend)
    reps = ring_reps(len(cps))
    ring = fps_ring(pv, cps, background, budget, backend)
    seconds = time_replays(ring, reps, pv.device)
    frames = len(cps) * reps
    return {"fps": frames / seconds, "budget": budget, "frames": frames,
            "reps": reps, "capture_s": ring.capture_s,
            "launches": ring.launches, "num_rendered_max": needed}


def ring_reps(n_views: int) -> int:
    """How often root render.py repeats n_views views in its timed
    launch: to at least FPS_MIN_FRAMES frames."""
    return max(1, -(-FPS_MIN_FRAMES // n_views))


def main(argv=None):
    from reduced3dgs_torch import config as C
    from reduced3dgs_torch.device import resolve
    from reduced3dgs_torch.graphs import log_launches_at_exit
    from reduced3dgs_torch.scene import Scene

    parser = ArgumentParser(description="Testing script parameters")
    C.add_model_params(parser, fill_none=True)
    C.add_pipeline_params(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_measure_fps", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--variable_sh_bands", action="store_true")
    parser.add_argument("--models", nargs="+", type=str,
                        default=["baseline", "quantised_half"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain PyTorch "
                             "versions of the kernels)")
    parser.add_argument("--trace", action="store_true",
                        help="trace the run into fps_results.json")
    args = C.get_combined_args(parser, argv)
    device = resolve(args.device)
    log_launches_at_exit("render")
    tracer = profiling.enable() if args.trace else None
    print(f"Rendering {args.model_path} on {device}")

    dataset = C.extract_model(args)
    pipe = C.extract_pipeline(args)
    scene = Scene(dataset, load_iteration=args.iteration, shuffle=False)
    background = torch.tensor(
        [1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
        device=device)

    fps_results = {}
    for model in args.models:
        conf = MODELS_CONFIG[model]
        pv = PoolView(scene.load_model(
            quantised=conf["quantised"], half_float=conf["half_float"],
            pack_xyz=conf.get("pack_xyz", False), device=device),
            variable_sh=args.variable_sh_bands)
        sets = []
        if not args.skip_train:
            sets.append(("train", scene.get_train_cameras()))
        if not args.skip_test:
            sets.append(("test", scene.get_test_cameras()))
        for split, cams in sets:
            render_set(pv, cams, background,
                       os.path.join(args.model_path, split, model,
                                    f"ours_{scene.loaded_iter}"),
                       pipe.backend)

        cams = (scene.get_test_cameras() or scene.get_train_cameras())[:50]
        if cams and not args.skip_measure_fps:
            w, h = cams[0].width, cams[0].height
            cams = [c for c in cams if (c.width, c.height) == (w, h)]
            res = measure_fps(pv, cams, background, pipe.backend)
            fps_results[model] = res["fps"]
            print(f"Model {model}: {res['fps']:.1f} FPS ({len(cams)} views "
                  f"x {res['reps']} reps in one timed window) on {device} "
                  f"(budget {res['budget']})")

    if tracer is not None:
        fps_results["trace"] = profiling.snapshot()
        tracer.close()
    with open(os.path.join(args.model_path, "fps_results.json"), "w") as f:
        json.dump(fps_results, f, indent=2)


if __name__ == "__main__":
    main()
