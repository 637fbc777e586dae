"""Frozen plain copy of the port's ``ops/kpconv_common.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

The KPConv influence weights (only this function of the original).
"""
from __future__ import annotations

import torch


def influence_fn(d2: torch.Tensor, kp_extent: float, influence: str) -> torch.Tensor:
    if influence == "linear":
        return torch.clamp(1.0 - torch.sqrt(d2.clamp_min(0.0)) / kp_extent, min=0.0)
    if influence == "gaussian":
        sigma = kp_extent * 0.3
        return torch.exp(-d2 / (2.0 * sigma**2 + 1e-9))
    if influence == "constant":
        return torch.ones_like(d2)
    raise ValueError(f"Unknown KP influence: {influence}")
