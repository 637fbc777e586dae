"""Frozen plain copy of the port's ``ops/kpconv_tiled.py``: only the
strided-shortcut max-pool of the tiled route, whose gradient goes whole to
the first maximal neighbor (the port's K5 on the card).  The candidate-tile
KPConv itself is the dense formulation here (``models/kpconv.py``)."""
from __future__ import annotations

import torch

from perfbench.reference.ops.masked import pad_gather


def maxpool_bwd_plain(g, amax, inds, ns: int):
    """g [Nq, C], amax [Nq, C] int64 (neighbor slot of the first maximum),
    inds [Nq, H] int64 (pad >= Ns) -> ds [Ns, C] with
    ds[inds[q, amax[q, c]], c] += g[q, c], shadows dropped."""
    c_in = g.shape[1]
    rows = inds.gather(1, amax)  # [Nq, C]
    valid = (rows >= 0) & (rows < ns)
    flat = rows * c_in + torch.arange(c_in, device=g.device)
    ds = torch.zeros(ns * c_in, device=g.device, dtype=g.dtype)
    return ds.index_add_(0, flat[valid], g[valid]).reshape(ns, c_in)


class _MaxPoolTiledFn(torch.autograd.Function):
    """Gather + max over the neighbors (shadow rows are 0); the gradient to
    the first maximum."""

    @staticmethod
    def forward(ctx, x, inds):
        out, amax = pad_gather(x, inds, 0.0).max(dim=1)  # first maximum on ties
        ctx.save_for_backward(amax, inds)
        ctx.ns = x.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        amax, inds = ctx.saved_tensors
        return maxpool_bwd_plain(g.contiguous(), amax, inds, ctx.ns), None


def max_pool_tiled(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """x [Ns, C], inds [Nq, H] int64 (pad >= Ns) -> [Nq, C]."""
    return _MaxPoolTiledFn.apply(x, inds)
