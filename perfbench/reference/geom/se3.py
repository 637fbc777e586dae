"""Frozen plain copy of the port's ``geom/se3.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

SE(3) helpers the loss uses (counterpart of ``pcrcg_tpu/geom/se3.py``).

A transform is a [..., 3, 4] matrix (rotation | translation).
"""
from __future__ import annotations

import torch


def from_rt(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """rot [..., 3, 3], trans [..., 3] or [..., 3, 1] -> [..., 3, 4]."""
    if trans.shape[-1] == 1:
        trans = trans[..., 0]
    return torch.cat([rot, trans[..., None]], dim=-1)


def transform(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply g [..., 3, 4] to pts [..., N, 3] -> [..., N, 3]."""
    return pts @ g[..., :3, :3].transpose(-1, -2) + g[..., None, :3, 3]
