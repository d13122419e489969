"""Renderer facade (PyTorch): preprocess -> tile binning -> compositing.

Counterpart of reduced3dgs_tpu/renderer.py.  Differentiable in the raw
parameters (and ``screen_offset``); callers that only serve wrap it in
torch.inference_mode (reduced3dgs_torch/render.py), so no graph is built.
Backends:

  * "tile" — the tile rasterizer (ops/tile_render.py): kernels K1 + K2
             forward, K3 + K5/K6 backward and K4 for the transmittance
             statistics on a CUDA tensor, their plain versions on a CPU
             tensor.
  * "ref"  — the masked pixel-by-instance oracle (ops/render_ref.py),
             O(pixels * B), differentiable by autograd: the gradient
             oracle; small images and tests only.

The per-frame instance count is data-dependent; callers pass a static
``instance_budget`` and ``out.num_rendered`` reports the true count (plus
alignment-slack overflow) so the host can grow the budget and redo the
frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reduced3dgs_torch.ops import binning as binning_ops
from reduced3dgs_torch.ops import preprocess as prep_ops
from reduced3dgs_torch.ops import transforms as tf
from reduced3dgs_torch.ops.preprocess import CameraParams

BACKENDS = ("tile", "ref")
STAGES = ("preprocess", "binning", "composite")


def _mark(marks):
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)


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
    marks: list | None = None,
) -> RenderOut:
    """Render one view; every tensor lies on one device (the camera's).

    grad_reduce: the "tile" backend's per-primitive gradient reduction,
    "f32" or "bf16x2" (packed payload and the fast feature table, as in
    the JAX package).  marks: on a CUDA device, a list that receives a
    timing event recorded before the first stage and after each of
    STAGES (stage times); the tile backward appends three more (see
    tile_render._RasterizeCore).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")
    _mark(marks)
    prep = prep_ops.preprocess(
        xyz, scaling_raw, rotation_raw, opacity_raw, features, degrees, cam,
        alive_mask=alive_mask, scale_modifier=scale_modifier,
        color_precomp=color_precomp, screen_offset=screen_offset)
    _mark(marks)
    b = binning_ops.bin_gaussians(prep, width, height, instance_budget)
    _mark(marks)
    # Overflow report: num_rendered > budget means truncation, and
    # total_padded > b_pad means the alignment slack pool ran out (the
    # layout was clamped).  Both fold into one number the regrow loops
    # understand: grow the budget and redo the frame.
    b_pad = b.gauss_aligned.shape[0]
    nr_report = torch.where(
        b.total_padded > b_pad,
        torch.clamp(b.num_rendered, min=instance_budget + 1),
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
            want_transmittance=want_transmittance, grad_reduce=grad_reduce,
            marks=marks)
    _mark(marks)
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
