"""Robust losses on squared errors, as (value, derivative) jets.

Port of `visual_inertial_bundle_adjustment_tpu/ops/losses.py` (reference
lib/small_thing/SoftLoss.h:1-211): each loss maps the squared whitened error
s = ||e||^2 to (rho(s), rho'(s)). A loss is a (kind, a, k) triple of Python
scalars per factor batch; `loss_jet2` is branch-free over the tensor.
"""

from __future__ import annotations

import torch

TRIVIAL = 0
L1 = 1
HUBER = 2
HUBER_CUTOFF = 3
CAUCHY = 4


def loss_jet2(kind: int, a: float, k: float, s):
    """Return (rho(s), rho'(s)) for each element of s."""
    s_safe = torch.clamp(s, min=1e-30)
    r = torch.sqrt(s_safe)
    b = a * a
    h = 2.0 * a * k - b
    one = torch.ones_like(s)
    if kind == TRIVIAL:
        return s, one
    if kind == L1:
        return r, 0.5 / r
    in_quad = s <= b
    v_hub = torch.where(in_quad, s, 2.0 * a * r - b)
    d_hub = torch.where(in_quad, one, a / r)
    if kind == HUBER:
        return v_hub, d_hub
    if kind == HUBER_CUTOFF:
        past_cut = s > k * k
        return (torch.where(past_cut, torch.full_like(s, h), v_hub),
                torch.where(past_cut, torch.zeros_like(s), d_hub))
    if kind == CAUCHY:
        sum_ = 1.0 + s / max(b, 1e-30)
        return b * torch.log(sum_), 1.0 / sum_
    raise ValueError(f"unknown loss kind {kind}")
