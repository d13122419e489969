"""Adam with torch semantics on the pool (plain functions on tensors).

Counterpart of reduced3dgs_tpu/train/adam.py, not torch.optim.Adam: the
update rounds as the reference's torch.optim.Adam(eps=1e-15) does in the
JAX package,

  m = b1 m + (1-b1) g;  v = b2 v + (1-b2) g^2
  p -= lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)

(eps outside the sqrt; torch.optim.Adam divides sqrt(v) by sqrt(1-b2^t)
instead), with one step count per leaf, a skip flag per leaf (a skipped
leaf keeps its parameters, moments and count) and rows of a pool that
train/densify.py zeroes when it reuses a slot.  The bias corrections and
the learning-rate schedule are computed in float32, as the JAX package
computes them on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    mu: NamedTuple  # like params
    nu: NamedTuple  # like params
    step: NamedTuple  # like params, one Python int per leaf


def init(params) -> AdamState:
    def zeros():
        return type(params)(*(torch.zeros_like(p) for p in params))

    return AdamState(mu=zeros(), nu=zeros(),
                     step=type(params)(*(0 for _ in params)))


def _f32(x):
    return np.float32(x)


def _correction(b, t):
    """1 - b^t in float32."""
    return float(_f32(1.0) - np.power(_f32(b), _f32(t)))


def corrections(t, b1=0.9, b2=0.999):
    """The bias corrections (1 - b1^t, 1 - b2^t) of step t, float32
    values as Python floats."""
    return _correction(b1, t), _correction(b2, t)


@torch.no_grad()
def update(params, grads, state: AdamState, lr_tree, b1=0.9, b2=0.999,
           eps=1e-15, skip_tree=None, bias=None):
    """One Adam step; lr_tree holds one float (or 0-dim float32 tensor)
    per leaf.  skip_tree: optional per-leaf bools — True leaves stay
    untouched (the torch behaviour for a parameter whose .grad is None).
    bias: optional per-leaf (c1, c2) 0-dim float32 tensors that stand
    for corrections(step + 1) — what a captured CUDA graph reads, filled
    before each replay; a tensor and a Python float of the same float32
    value round alike.  Returns (params, state) as new tensors."""
    cls = type(params)
    if skip_tree is None:
        skip_tree = cls(*(False for _ in params))
    if bias is None:
        bias = cls(*(None for _ in params))
    out = []  # (p, m, v, t) per leaf
    for p, g, m, v, t, lr, skip, cc in zip(params, grads, state.mu, state.nu,
                                           state.step, lr_tree, skip_tree,
                                           bias):
        if skip:
            out.append((p, m, v, t))
            continue
        c1, c2 = corrections(t + 1, b1, b2) if cc is None else cc
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        out.append((p - lr * (m2 / c1) / (torch.sqrt(v2 / c2) + eps),
                    m2, v2, t + 1))
    p, m, v, t = (cls(*leaves) for leaves in zip(*out))
    return p, AdamState(mu=m, nu=v, step=t)


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-lerp learning-rate schedule (the reference's get_expon_lr_func),
    in float32; returns a Python float."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    s = _f32(step)
    if lr_delay_steps > 0:
        ramp = np.clip(s / _f32(lr_delay_steps), _f32(0), _f32(1))
        delay_rate = _f32(lr_delay_mult) + _f32(1 - lr_delay_mult) * np.sin(
            _f32(0.5 * math.pi) * ramp)
    else:
        delay_rate = _f32(1.0)
    t = np.clip(s / _f32(max_steps), _f32(0.0), _f32(1.0))
    log_lerp = np.exp(_f32(math.log(lr_init)) * (_f32(1) - t)
                      + _f32(math.log(lr_final)) * t)
    return 0.0 if s < 0 else float(_f32(delay_rate * log_lerp))
