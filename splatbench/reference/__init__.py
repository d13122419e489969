"""The plain PyTorch references that decide `correct`.  They import
nothing of the program and take nothing it made."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_precision():
    """float32 products and convolutions without TF32 (the card would
    otherwise run them at TF32 precision)."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
