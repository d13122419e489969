"""Reference (oracle) compositor in plain PyTorch — the "slow truth".

Counterpart of reduced3dgs_tpu/ops/render_ref.py and the port's "ref"
backend: front-to-back alpha compositing in (tile, depth rank) order,
every pixel against every binned instance, with

  alpha   = min(0.99, opacity * exp(power)),      power <= 0 else skip
  skip    if alpha < 1/255
  stop    before blending a primitive that would push T below 1e-4
  color  += c_i * alpha_i * T;  T *= (1 - alpha_i)
  out     = color + T_final * bg

O(pixels * B): for small images and tests only.
"""

from __future__ import annotations

import torch

from reduced3dgs_torch.ops.binning import BinningOut
from reduced3dgs_torch.ops.preprocess import (
    TILE_X, TILE_Y, PreprocessOut, tile_grid,
)

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1.0e-4
PIXEL_CHUNK = 4096  # pixels composited at once (bounds the (N, B) arrays)


def _composite_chunk(pix_xy, pix_tile, inst_tile, inst_xy, inst_conic,
                     inst_opac, inst_color, background):
    """Composite one chunk of pixels against ALL B instances.
    Returns (color (N,3), t_final (N,), t_prev (N,B), contrib (N,B))."""
    d = inst_xy[None, :, :] - pix_xy[:, None, :]  # (N,B,2)
    power = (
        -0.5 * (inst_conic[None, :, 0] * d[..., 0] ** 2
                + inst_conic[None, :, 2] * d[..., 1] ** 2)
        - inst_conic[None, :, 1] * d[..., 0] * d[..., 1]
    )  # (N,B)
    alpha = torch.clamp(inst_opac[None, :] * torch.exp(power),
                        max=ALPHA_CLAMP)
    hit = ((pix_tile[:, None] == inst_tile[None, :])
           & (power <= 0.0) & (alpha >= ALPHA_MIN))
    eff = torch.where(hit, alpha, 0.0)

    one_m = 1.0 - eff
    t_incl = torch.cumprod(one_m, dim=1)  # T after instance i
    t_prev = t_incl / one_m  # exclusive; eff <= 0.99 < 1
    contrib = hit & (t_incl >= T_EPS)
    w = torch.where(contrib, eff * t_prev, 0.0)  # blend weights (N,B)

    color = w @ inst_color  # (N,3)
    t_final = torch.where(contrib, t_incl, 1.0).amin(dim=1)
    out = color + t_final[:, None] * background[None, :]
    return out, t_final, t_prev, contrib


def render_ref(prep: PreprocessOut, binning: BinningOut, background,
               width: int, height: int, want_transmittance: bool = False):
    """Render the full image: (color (H,W,3), final_T (H,W)); with
    want_transmittance also (trans_sum (P,), touched (P,) int32), the
    per-primitive sum of the transmittance before each blend and the
    count of blending pixels (no gradient)."""
    grid_x, _ = tile_grid(width, height)
    dev = prep.means2d.device
    # binning ids are depth ranks; translate to original primitive ids
    gauss_id = binning.prim_order.long()[binning.gauss_id().long()]
    inst_xy = prep.means2d[gauss_id]
    inst_conic = prep.conic[gauss_id]
    inst_opac = prep.opacity[gauss_id]
    inst_color = prep.color[gauss_id]
    # alignment-slack slots carry a real tile id; mask them out
    inst_tile = torch.where(binning.pad_mask, -2, binning.tile_id)
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij")
    pix_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    pix_tile = ((ys.to(torch.int32) // TILE_Y) * grid_x
                + xs.to(torch.int32) // TILE_X).reshape(-1)

    outs, ts = [], []
    b = inst_tile.shape[0]
    trans_sum = torch.zeros(b, dtype=torch.float32, device=dev)
    touch_sum = torch.zeros(b, dtype=torch.int32, device=dev)
    for i in range(0, pix_xy.shape[0], PIXEL_CHUNK):
        out, t, t_prev, contrib = _composite_chunk(
            pix_xy[i:i + PIXEL_CHUNK], pix_tile[i:i + PIXEL_CHUNK],
            inst_tile, inst_xy, inst_conic, inst_opac, inst_color, bg)
        if want_transmittance:
            with torch.no_grad():
                trans_sum += torch.where(contrib, t_prev, 0.0).sum(dim=0)
                touch_sum += contrib.sum(dim=0).to(torch.int32)
        outs.append(out)
        ts.append(t)
    color = torch.cat(outs, dim=0).reshape(height, width, 3)
    t_final = torch.cat(ts, dim=0).reshape(height, width)
    if want_transmittance:
        num_p = prep.means2d.shape[0]
        g_trans = torch.zeros(num_p, dtype=torch.float32,
                              device=dev).index_add_(0, gauss_id, trans_sum)
        g_touch = torch.zeros(num_p, dtype=torch.int32,
                              device=dev).index_add_(0, gauss_id, touch_sum)
        return color, t_final, g_trans, g_touch
    return color, t_final
