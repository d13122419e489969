"""Training losses / image metrics (PyTorch).

Counterpart of reduced3dgs_tpu/ops/losses.py: L1, L2, PSNR and the windowed
SSIM (11x11 Gaussian window, sigma 1.5, as two separable 11-tap passes).
Images are (..., H, W, C) channels-last, as in the JAX package.

``ssim_band_sum`` is the band decomposition the multi-device step uses.

Precision: the JAX package runs the two depthwise passes at
Precision.HIGHEST.  A float32 convolution on the card runs in TF32 by
default (torch.backends.cudnn.allow_tf32 is True), so ``_blur`` turns
TF32 off for its convolutions, forward and backward: the blur is an
autograd Function whose backward is the same blur (a same-padded
correlation with a symmetric window is its own adjoint), run under the
same cudnn flags.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2
WINDOW = 11
SIGMA = 1.5


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def l2_loss(pred, target):
    return ((pred - target) ** 2).mean()


def abs_jax(x):
    """|x| with JAX's derivative: sign taken as +1 at x = 0 (jax.grad of
    jnp.abs gives 1 there, torch's abs 0).  The regularizers of the
    training loss use it, so a coefficient or opacity at exactly 0 gets
    the gradient the JAX package gives it."""
    return x * torch.where(x >= 0, 1.0, -1.0)


def psnr(pred, target):
    """Per-image PSNR, inputs (..., H, W, C) in [0,1]."""
    mse = ((pred - target) ** 2).reshape(pred.shape[:-3] + (-1,)).mean(-1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_1d(window_size: int, sigma: float, device):
    """The normalised 1-D window, computed in float64 on `device` (as the
    JAX package computes it in numpy) and rounded to float32; made on the
    device, so no host copy per call."""
    x = torch.arange(window_size, dtype=torch.float64,
                     device=device) - window_size // 2
    g = torch.exp(-(x * x) / (2.0 * sigma ** 2))
    return (g / g.sum()).to(torch.float32)


def _sep_conv(x, win, v_pad=None):
    """Separable blur of (N, C, H, W), full f32 (no TF32): horizontal
    same-padded, then vertical with v_pad rows of zeros on each side
    (None: same-padded; 0: valid, H - (k - 1) rows out)."""
    c = x.shape[1]
    k = win.shape[0]
    v_pad = k // 2 if v_pad is None else v_pad
    kh = win.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    kv = win.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False):
        x = F.conv2d(x, kh, padding=(0, k // 2), groups=c)
        return F.conv2d(x, kv, padding=(v_pad, 0), groups=c)


class _Blur(torch.autograd.Function):
    """_sep_conv with its adjoint as the backward: the window is
    symmetric, so the adjoint of a correlation padded by v rows is the
    same correlation padded by k - 1 - v rows (same-padded: itself)."""

    @staticmethod
    def forward(ctx, x, win, v_pad=None):
        ctx.save_for_backward(win)
        ctx.v_pad = v_pad
        return _sep_conv(x, win, v_pad)

    @staticmethod
    def backward(ctx, g):
        (win,) = ctx.saved_tensors
        v_pad = None if ctx.v_pad is None else win.shape[0] - 1 - ctx.v_pad
        return _sep_conv(g.contiguous(), win, v_pad), None, None


def _ssim_map(m, n):
    """SSIM map from the blurred moment stack (5n, ...) -> (n, ...)."""
    mu1, mu2, e11, e22, e12 = (m[i * n:(i + 1) * n] for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    return ((2 * mu1_mu2 + _C1) * (2 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )


def ssim(img1, img2, window_size: int = WINDOW):
    """Mean SSIM over an (H,W,C) (or (N,H,W,C)) image pair, with the
    reference's per-channel same-padded window."""
    if img1.ndim == 3:
        img1 = img1[None]
        img2 = img2[None]
    n = img1.shape[0]
    win = _gaussian_1d(window_size, SIGMA, img1.device)
    m = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    m = _Blur.apply(m.permute(0, 3, 1, 2).contiguous(), win)
    return _ssim_map(m, n).mean()


def ssim_band_sum(img1, img2, band_start: int, band_rows: int,
                  window_size: int = WINDOW):
    """Sum of the same-padded SSIM map of an (H, W, C) pair over the rows
    [band_start, band_start + band_rows) that lie in [0, H).

    The band decomposition of ``ssim`` (the JAX package's, losses.py:102):
    the horizontal pass same-padded, then a valid vertical pass over the
    band's slab of the zero-padded image gives the same-padded map's rows
    of the band, so the sums over a disjoint row cover add up to
    ssim * H * W * C (parallel/sharded.py: each tile rank sums its band)."""
    h, w, c = img1.shape
    pad = window_size // 2
    win = _gaussian_1d(window_size, SIGMA, img1.device)

    def slab(x):
        x = F.pad(x, (0, 0, 0, 0, pad, pad + band_rows))
        return x[band_start:band_start + band_rows + 2 * pad][None]

    a, b = slab(img1), slab(img2)
    m = torch.cat([a, b, a * a, b * b, a * b])
    m = _Blur.apply(m.permute(0, 3, 1, 2).contiguous(), win, 0)
    ssim_map = _ssim_map(m, 1)  # (1, C, band_rows, W)
    row = band_start + torch.arange(band_rows, device=img1.device)
    return torch.where((row < h)[None, None, :, None], ssim_map, 0.0).sum()
