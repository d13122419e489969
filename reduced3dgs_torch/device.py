"""Device selection — the counterpart of reduced3dgs_tpu/platform.py.

Entry points default to the CUDA card.  Without a card they raise unless
the caller explicitly asked for the CPU (``device="cpu"`` /
``--device cpu``, as the tests do): nothing falls back silently.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """Return the torch.device to run on, raising if it is a missing card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
