"""LPIPS (VGG16) perceptual metric in PyTorch.

Counterpart of reduced3dgs_tpu/ops/lpips.py: inputs scaled to [-1, 1] and
shifted / scaled per channel, the VGG16 feature stacks tapped after the
five relu blocks (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), channels
normalised to unit length, the learned 1x1 heads, the mean over space
summed over the layers.

No weights are downloaded.  They come from an .npz at the path given, at
$R3DGS_LPIPS_WEIGHTS, or at <repo>/weights/lpips_vgg.npz (the JAX
package's resolution and keys):
  conv{i}_weight / conv{i}_bias   (13 VGG convs, OIHW)
  lin{k}_weight                   (5 LPIPS heads, (1, C, 1, 1))
``lpips_fn()`` returns None when there is no such file (metrics then
reports LPIPS as null).  The convolutions run in full float32 (TF32 off,
as the port's SSIM).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from reduced3dgs_torch.device import resolve

# VGG16 conv plan: output channels, "M" a 2x2 max pool
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512]
# the convs (0-based) whose relu feeds LPIPS
TAPS = (1, 3, 6, 9, 12)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def weights_path():
    return os.environ.get(
        "R3DGS_LPIPS_WEIGHTS",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "weights", "lpips_vgg.npz"))


def load_weights(path=None):
    """(convs [(weight, bias)], heads [weight]) as numpy arrays, or None
    when the file does not exist."""
    path = path or weights_path()
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        convs = []
        while f"conv{len(convs)}_weight" in data:
            i = len(convs)
            convs.append((data[f"conv{i}_weight"], data[f"conv{i}_bias"]))
        heads = [data[f"lin{k}_weight"] for k in range(len(TAPS))]
    return convs, heads


class LPIPS(torch.nn.Module):
    """lpips(img1, img2) over (H, W, 3) images in [0, 1]; a 0-dim
    tensor."""

    def __init__(self, convs, heads):
        super().__init__()
        for i, (w, b) in enumerate(convs):
            self.register_buffer(f"conv{i}_weight", torch.as_tensor(w))
            self.register_buffer(f"conv{i}_bias", torch.as_tensor(b))
        for k, w in enumerate(heads):
            self.register_buffer(f"lin{k}_weight",
                                 torch.as_tensor(w).reshape(1, -1, 1, 1))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def features(self, x):
        feats = []
        ci = 0
        for spec in VGG_CFG:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(F.conv2d(x, getattr(self, f"conv{ci}_weight"),
                                getattr(self, f"conv{ci}_bias"), padding=1))
            if ci in TAPS:
                feats.append(x)
            ci += 1
        return feats

    def _prep(self, img):
        x = img.permute(2, 0, 1)[None] * 2.0 - 1.0
        return (x - self.shift) / self.scale

    @torch.no_grad()
    def forward(self, img1, img2):
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            f1 = self.features(self._prep(img1))
            f2 = self.features(self._prep(img2))
        total = torch.zeros((), dtype=torch.float32, device=img1.device)
        for k, (a, b) in enumerate(zip(f1, f2)):
            a = a / torch.clamp(torch.linalg.vector_norm(
                a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(
                b, dim=1, keepdim=True), min=1e-10)
            d = (a - b) ** 2 * getattr(self, f"lin{k}_weight")
            total = total + d.sum(dim=1).mean()
        return total


def lpips_fn(path=None, device=None):
    """An LPIPS module on `device` (default: the card), or None when the
    weights are not available."""
    w = load_weights(path)
    if w is None:
        return None
    return LPIPS(*w).to(resolve(device))
