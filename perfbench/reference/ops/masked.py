"""Frozen plain copy of the port's ``ops/masked.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

Masked-tensor primitives (counterpart of ``pcrcg_tpu/ops/masked.py``).

Static-shape convention: point tensors are padded to a fixed budget, pad
rows sit at ``PAD_COORD``, ``mask`` marks real rows, and neighbor-index
tensors hold values in [0, N] where N is the shadow index.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# Shadow coordinate for pad points (reference models/blocks.py:269).
PAD_COORD = 1.0e6


def pad_gather(x: torch.Tensor, idx: torch.Tensor, fill_value=0.0) -> torch.Tensor:
    """Rows of x [N, ...] at idx [...] (any integer dtype); idx == N (or any
    out-of-range index) gives a shadow row filled with ``fill_value``."""
    n = x.shape[0]
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    rows = x[idx.clamp(0, max(n - 1, 0))]
    valid = valid.reshape(valid.shape + (1,) * (x.dim() - 1))
    # new_full fills on the device: a host scalar copied there would block
    # the host until the device caught up.
    return torch.where(valid, rows, x.new_full((), fill_value))


def pad_gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pad_gather(x, idx, 0.0)`` as an ``index_select`` from x with one zero
    row appended, so its backward is an ``index_add_`` (atomic on the card)
    rather than the sort-based accumulate of ``x[idx]``'s; the shadow rows'
    gradient lands on the appended row and is dropped."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    xp = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xp.index_select(0, idx.reshape(-1)).reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim, keepdim: bool = False):
    """Mean of x over ``dim`` counting only rows where mask (broadcastable
    to x) is true."""
    m = mask.to(x.dtype)
    total = torch.sum(x * m, dim=dim, keepdim=keepdim)
    count = torch.sum(m.expand(x.shape), dim=dim, keepdim=keepdim).clamp_min(1.0)
    return total / count


def masked_instance_norm(x: torch.Tensor, mask: torch.Tensor, dim, eps: float = 1e-5,
                         psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Per-channel normalization over the masked ``dim`` dims (torch
    InstanceNorm with affine=False, biased variance), restricted to real
    rows; pad rows come out zero.  x: [..., C]; mask: x's leading dims.

    ``psum`` (the cloud axis, ``parallel/cloud.py``): x holds one part of
    the rows and ``psum`` sums a tensor over the parts, so the statistics
    are those of all the parts' rows, in the same two passes: the count
    and the sum for the mean, then the sum of (x − mean)²."""
    m = mask.to(x.dtype)[..., None]
    if psum is None:
        mean = masked_mean(x, m, dim=dim, keepdim=True)
        var = masked_mean((x - mean) ** 2, m, dim=dim, keepdim=True)
    else:
        count = torch.sum(m.expand(x.shape), dim=dim, keepdim=True)
        total, count = psum(torch.cat([torch.sum(x * m, dim=dim, keepdim=True), count])).chunk(2)
        count = count.clamp_min(1.0)
        mean = total / count
        var = psum(torch.sum((x - mean) ** 2 * m, dim=dim, keepdim=True)) / count
    normed = (x - mean) / torch.sqrt(var + eps)
    return normed * m


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with invalid entries excluded; rows with no valid
    entry return all zeros."""
    neg = torch.finfo(logits.dtype).min
    masked_logits = torch.where(mask, logits, torch.full_like(logits, neg))
    masked_logits = masked_logits - masked_logits.amax(dim=dim, keepdim=True)
    unnorm = torch.exp(masked_logits) * mask.to(logits.dtype)
    denom = unnorm.sum(dim=dim, keepdim=True)
    return unnorm / denom.clamp_min(1e-12)


def masked_logsumexp(x: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """logsumexp over ``dim`` restricted to masked entries; rows with no
    valid entry return a large negative value."""
    neg = -1.0e9
    masked_x = torch.where(mask, x, torch.full_like(x, neg))
    mx = masked_x.amax(dim=dim, keepdim=True).clamp_min(neg)
    s = torch.sum(torch.exp(masked_x - mx) * mask.to(x.dtype), dim=dim, keepdim=True)
    out = mx + torch.log(s.clamp_min(1e-30))
    return out.squeeze(dim)
