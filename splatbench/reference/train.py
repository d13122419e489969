"""Plain PyTorch reference of one training iteration of the paper's
`full_final` configuration: the render, the loss, its gradient in the
raw parameters and Adam's update.

The loss is the published one (Kerbl et al. 2023, eq. 7, with the
reduced-3DGS terms of Papantonakis et al. 2024):

  (1 - l_dssim) L1 + l_dssim (1 - SSIM)
  + l_alpha * mean over visible primitives of sigmoid(opacity)
  + l_sh * sum over visible primitives of |f_rest| / (visible * 45)

SSIM is the published 11x11 Gaussian window (sigma 1.5), zero padded.
|x| is differentiated as +1 at 0.  Adam keeps one step count per leaf
and adds eps outside the square root of the bias-corrected second
moment; its bias corrections and the position learning rate's
log-linear schedule are float32 values.  Nothing of the program is
imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from splatbench.reference import raster

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
B1, B2, EPS = 0.9, 0.999, 1e-15


def _window(dtype, device):
    x = torch.arange(11, dtype=torch.float64, device=device) - 5
    g = torch.exp(-(x * x) / (2 * 1.5 ** 2))
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(dtype)


def ssim(a, b):
    """Mean SSIM of two (H, W, 3) images."""
    w = _window(a.dtype, a.device).expand(3, 1, 11, 11).contiguous()
    x = a.permute(2, 0, 1)[None]
    y = b.permute(2, 0, 1)[None]

    def blur(t):
        return F.conv2d(t, w, padding=5, groups=3)

    mx, my = blur(x), blur(y)
    sxx = blur(x * x) - mx * mx
    syy = blur(y * y) - my * my
    sxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mx * my + c1) * (2 * sxy + c2)) / (
        (mx * mx + my * my + c1) * (sxx + syy + c2))
    return m.mean()


def _abs(x):
    return x * torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def lr_xyz(iteration, extent, opt):
    """The position learning rate at `iteration` (float32 arithmetic)."""
    f = np.float32
    init = opt["position_lr_init"] * extent
    final = opt["position_lr_final"] * extent
    s = f(iteration)
    t = np.clip(s / f(opt["position_lr_max_steps"]), f(0), f(1))
    lerp = np.exp(f(math.log(init)) * (f(1) - t) + f(math.log(final)) * t)
    # no delay ramp: the schedule's delay steps are 0
    return float(f(f(1.0) * lerp))


def learning_rates(iteration, extent, opt):
    fl = opt["feature_lr"]
    return dict(xyz=lr_xyz(iteration, extent, opt), features_dc=fl,
                features_rest=fl / 20.0, scaling=opt["scaling_lr"],
                rotation=opt["rotation_lr"], opacity=opt["opacity_lr"])


def correction(b, t):
    return float(np.float32(1.0) - np.power(np.float32(b), np.float32(t)))


def loss_and_grads(params, degrees, alive, cam: raster.Camera, gt, bg, opt,
                   rows=None):
    """(loss, {leaf: gradient}, the view's raster.pad_share) of one
    render of `params` (float tensors of the leaves).  rows: the image
    loss over the first `rows` pixel rows only (a planted fault)."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    sh = torch.cat([leaves["features_dc"], leaves["features_rest"]], 1)
    p = raster.project(leaves["xyz"], sh, leaves["scaling"],
                       leaves["rotation"], leaves["opacity"][:, 0], degrees,
                       alive, cam)
    flat = [t.detach().requires_grad_(True)
            for t in (p.xy, p.conic, p.opacity, p.colour)]
    bins = raster.bin_tiles(p, cam.width, cam.height)
    with torch.no_grad():
        img = raster.composite(p, bins, bg, cam.width, cam.height)
    img = img.requires_grad_(True)
    ld = opt["lambda_dssim"]
    a, b = (img, gt) if rows is None else (img[:rows], gt[:rows])
    image_loss = (1 - ld) * (a - b).abs().mean() + ld * (1 - ssim(a, b))
    (g_img,) = torch.autograd.grad(image_loss, img)
    raster.render_backward(p, flat, bins, bg, cam.width, cam.height,
                           g_img.detach())
    vis = p.radius > 0
    nvis = torch.clamp(vis.sum(), min=1).to(img.dtype)
    extra = torch.zeros((), dtype=img.dtype, device=img.device)
    if opt["lambda_alpha_regul"] > 0:
        op = torch.sigmoid(leaves["opacity"][:, 0])
        extra = extra + opt["lambda_alpha_regul"] * torch.where(
            vis, _abs(op), 0.0).sum() / nvis
    if opt["lambda_sh_sparsity"] > 0:
        extra = extra + opt["lambda_sh_sparsity"] * torch.where(
            vis[:, None, None], _abs(leaves["features_rest"]),
            0.0).sum() / (nvis * 45)
    pulled = sum((t * f.grad).sum() for t, f in
                 zip((p.xy, p.conic, p.opacity, p.colour), flat))
    total = pulled + extra
    grads = torch.autograd.grad(total, [leaves[k] for k in LEAVES],
                                allow_unused=True)
    loss = image_loss.detach() + extra.detach()
    return loss, {k: (torch.zeros_like(params[k]) if g is None else g)
                  for k, g in zip(LEAVES, grads)}, raster.pad_share(bins)


@torch.no_grad()
def adam(params, grads, mu, nu, steps, lrs):
    """One Adam step of every leaf; returns new (params, mu, nu, steps)."""
    out = ({}, {}, {}, {})
    for k in LEAVES:
        t = steps[k] + 1
        c1, c2 = correction(B1, t), correction(B2, t)
        m = B1 * mu[k] + (1 - B1) * grads[k]
        v = B2 * nu[k] + (1 - B2) * grads[k] * grads[k]
        out[0][k] = params[k] - lrs[k] * (m / c1) / (torch.sqrt(v / c2) + EPS)
        out[1][k], out[2][k], out[3][k] = m, v, t
    return out
