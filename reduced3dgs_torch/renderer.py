"""Renderer facade (PyTorch): preprocess -> tile binning -> compositing.

Counterpart of reduced3dgs_tpu/renderer.py.  Differentiable in the raw
parameters (and ``screen_offset``); callers that only serve wrap it in
torch.inference_mode (reduced3dgs_torch/render.py), so no graph is built,
and on a card their preprocess is one kernel (ops/preprocess.py).
Backends:

  * "tile" — the tile rasterizer (ops/tile_render.py): kernels K1 + K2
             forward, K3 + K5/K6 backward and K4 for the transmittance
             statistics on a CUDA tensor, their plain versions on a CPU
             tensor.
  * "ref"  — the masked pixel-by-instance oracle (ops/render_ref.py),
             O(pixels * B), differentiable by autograd: the gradient
             oracle; small images and tests only.

The per-frame instance count is data-dependent; callers pass a static
``instance_budget`` and ``out.num_rendered`` reports the true count, or
more than the budget where the aligned layout does not fit its slots, so
the host can grow the budget and redo the frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reduced3dgs_torch.ops import binning as binning_ops
from reduced3dgs_torch.ops import preprocess as prep_ops
from reduced3dgs_torch.ops import transforms as tf
from reduced3dgs_torch.ops.preprocess import CameraParams
from reduced3dgs_torch.utils import profiling

BACKENDS = ("tile", "ref")


def mark_visible(xyz, cam: CameraParams):
    """(P,) bool frustum visibility: view-space z > 0.2, the same test the
    preprocess cull uses."""
    return tf.transform_points_3x3(xyz, cam.viewmatrix)[:, 2] > 0.2


class RenderOut(NamedTuple):
    color: torch.Tensor  # (H,W,3)
    final_t: torch.Tensor  # (H,W)
    radii: torch.Tensor  # (P,) int32
    visibility: torch.Tensor  # (P,) bool (radii > 0)
    means2d: torch.Tensor  # (P,2) pixel centers
    num_rendered: torch.Tensor  # () int32
    # with want_transmittance (SH-band culling): per primitive, the sum
    # of the transmittance before each of its blends and their count
    transmittance_sum: torch.Tensor | None = None  # (P,) f32
    pixels_touched: torch.Tensor | None = None  # (P,) int32


def render(
    xyz,
    features,  # (P, 16, 3) SH coefficients (dc + rest)
    scaling_raw,  # (P, 3) log-scales
    rotation_raw,  # (P, 4) unnormalized quaternions
    opacity_raw,  # (P,) raw (pre-sigmoid)
    degrees,  # (P,) int32
    cam: CameraParams,
    background,  # (3,)
    *,
    width: int,
    height: int,
    instance_budget: int,
    alive_mask=None,
    scale_modifier: float = 1.0,
    backend: str = "tile",
    color_precomp=None,
    screen_offset=None,
    grad_reduce: str = "f32",
    want_transmittance: bool = False,
    strip_r0: int | None = None,
    strip_rows: int | None = None,
) -> RenderOut:
    """Render one view; every tensor lies on one device (the camera's).

    strip_r0 / strip_rows ("tile" backend): bin and render only the strip
    of tile rows [strip_r0, strip_r0 + strip_rows), strip_rows * 16 pixel
    rows from row strip_r0 * 16 (the multi-device path); num_rendered is
    the strip's demand.

    grad_reduce: the "tile" backend's per-primitive gradient reduction,
    "f32" or "bf16x2" (packed payload and the fast feature table, as in
    the JAX package).

    Stage boundaries (utils/profiling.py): this marks "binning" and
    "composite"; the caller marks "preprocess" (with what it computes for
    the render first) and what follows the composite.  After binning the
    device counters take num_rendered, with the aligned budget, and
    total_padded, with the slack pool K1 lays pads out in (folded: its
    pad need, and the pads spilled past that pool into the budget's
    unused slots).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")
    prep = prep_ops.preprocess(
        xyz, scaling_raw, rotation_raw, opacity_raw, features, degrees, cam,
        alive_mask=alive_mask, scale_modifier=scale_modifier,
        color_precomp=color_precomp, screen_offset=screen_offset)
    device = prep.depths.device
    profiling.stage("binning", device)
    tile_rows = None if strip_rows is None else (strip_r0, strip_rows)
    if tile_rows is not None and backend != "tile":
        raise NotImplementedError("strip rendering is the tile backend's")
    b = binning_ops.bin_gaussians(prep, width, height, instance_budget,
                                  tile_rows=tile_rows)
    b_pad = b.gauss_aligned.shape[0]
    aligned = -(-instance_budget // binning_ops.ALIGN) * binning_ops.ALIGN
    overflow = b.total_padded > b_pad
    profiling.count("num_rendered", b.num_rendered, aux=aligned)
    profiling.count("total_padded", b.total_padded, aux=b_pad - aligned)
    profiling.stage("composite", device)
    # Overflow report: num_rendered > budget means truncation, and
    # total_padded > b_pad means the instances and their alignment pads
    # do not fit in the b_pad slots (K1 then keeps the JAX package's
    # layout, which loses the last tiles' pads).  Both fold into one
    # number the regrow loops understand: grow the budget and redo the
    # frame.  Every layout with total_padded <= b_pad is whole.
    nr_report = torch.where(
        overflow, torch.clamp(b.num_rendered, min=instance_budget + 1),
        b.num_rendered)

    if backend == "ref":
        from reduced3dgs_torch.ops.render_ref import render_ref

        out = render_ref(prep, b, background, width, height,
                         want_transmittance=want_transmittance)
        color, final_t = out[:2]
        g_trans, g_touch = out[2:] if want_transmittance else (None, None)
    else:
        from reduced3dgs_torch.ops.tile_render import tile_render

        color, final_t, g_trans, g_touch = tile_render(
            prep, b, background, width, height,
            want_transmittance=want_transmittance, tile_rows=tile_rows,
            grad_reduce=grad_reduce)
    return RenderOut(
        color=color,
        final_t=final_t,
        radii=prep.radii,
        visibility=prep.radii > 0,
        means2d=prep.means2d,
        num_rendered=nr_report,
        transmittance_sum=g_trans,
        pixels_touched=g_touch,
    )
