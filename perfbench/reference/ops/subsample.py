"""Frozen plain copy of the port's ``ops/subsample.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

Barycenter voxel-grid subsampling with a static output shape.

Counterpart of ``pcrcg_tpu/ops/subsample.py`` (reference
cpp_subsampling/grid_subsampling.cpp:5-106): origin corner =
floor(min_valid / dl)·dl, voxel = floor((p - origin) / dl), output = the
per-voxel barycenter, rows in voxel-key order (Morton by default, raster
when the grid exceeds 1024 cells per axis).  Voxels past ``n_out`` are
dropped and counted.

The barycenter is a segment sum over the key-sorted rows
(``torch.segment_reduce``, which adds each segment's rows in order): no
scatter atomics, so the result is the same on every run and every device,
and the fp32 sums round as the JAX package's in-order scatter-add does.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ops.masked import PAD_COORD

_INT_MAX = 2**31 - 1


def _spread_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _interleave(ijk: torch.Tensor) -> torch.Tensor:
    return (
        _spread_bits_10(ijk[:, 0])
        | (_spread_bits_10(ijk[:, 1]) << 1)
        | (_spread_bits_10(ijk[:, 2]) << 2)
    )


def morton_code(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Z-order code per point on a 1024³ grid over the valid bounding box;
    invalid rows map to INT_MAX so they sort last.  int64 [N]."""
    vmin = torch.where(mask[:, None], points, PAD_COORD).amin(0)
    vmax = torch.where(mask[:, None], points, -PAD_COORD).amax(0)
    extent = (vmax - vmin).amax().clamp_min(1e-6)
    ijk = ((points - vmin) / extent * 1023.0).to(torch.int64).clamp(0, 1023)
    return torch.where(mask, _interleave(ijk), _INT_MAX)


def _inv(dl: float) -> float:
    """1/dl rounded to fp32: the JAX package runs compiled, and XLA divides
    by a constant as a product with its fp32 reciprocal, which decides the
    voxel of points that sit on a cell boundary."""
    return float(np.float32(1.0 / dl))


def _grid_origin_dims(points, mask, dl):
    pmin = torch.where(mask[:, None], points, PAD_COORD).amin(0)
    pmax = torch.where(mask[:, None], points, -PAD_COORD).amax(0)
    origin = torch.floor(pmin * _inv(dl)) * dl
    dims = torch.floor((pmax - origin) * _inv(dl)).to(torch.int64) + 1
    return origin, dims


def grid_fits_morton(points: torch.Tensor, mask: torch.Tensor, dl: float) -> torch.Tensor:
    """Whether the voxel grid fits 1024 cells per axis (0-d bool tensor)."""
    _, dims = _grid_origin_dims(points, mask, dl)
    return torch.all(dims <= 1024)


def morton_sort(points: torch.Tensor, mask: torch.Tensor):
    """Sort points spatially (Z-order); pads stay at the tail.  Returns
    (points, mask, order)."""
    order = torch.argsort(morton_code(points, mask), stable=True)
    return points[order], mask[order], order


def grid_subsample(
    points: torch.Tensor,
    mask: torch.Tensor,
    dl: float,
    n_out: int,
    return_count: bool = False,
    order: str = "raster",
):
    """points [N,3], mask [N] -> (pooled [n_out,3], pooled_mask [n_out])
    (+ the number of occupied voxels with ``return_count``; count > n_out
    means voxels were dropped).  Pad outputs sit at PAD_COORD."""
    origin, dims = _grid_origin_dims(points, mask, dl)
    ijk = torch.floor((points - origin) * _inv(dl)).to(torch.int64)  # [N,3]
    key = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])
    if order == "morton":
        mkey = _interleave(ijk.clamp(0, 1023))
        key = torch.where(torch.all(dims <= 1024), mkey, key)
    elif order != "raster":
        raise ValueError(f"unknown order: {order}")
    key = torch.where(mask, key, _INT_MAX)

    perm = torch.argsort(key, stable=True)  # invalid rows sort last
    sorted_key = key[perm]
    sorted_valid = mask[perm]
    first = torch.ones_like(sorted_valid)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1  # dense voxel rank
    n_voxels = torch.where(sorted_valid, seg, -1).amax() + 1

    # Segment ends over the sorted valid rows (pads carry a rank past every
    # output, so the sequence stays sorted).
    seg_valid = torch.where(sorted_valid, seg, n_out + 1)
    ends = torch.searchsorted(
        seg_valid, torch.arange(n_out, device=points.device), right=True
    )
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    counts = ends - starts
    # One more segment takes the rows past the last output (dropped voxels
    # and pads), so the lengths cover every row.
    lengths = torch.cat([counts, (points.shape[0] - ends[-1:])])
    # ``unsafe``: the lengths cover every row by construction, and the
    # checks it skips read them back to the host (a sync on the card).
    sums = torch.segment_reduce(points[perm], "sum", lengths=lengths, axis=0,
                                unsafe=True)[:n_out]
    out_mask = counts > 0
    pooled = sums / counts.clamp_min(1).to(points.dtype)[:, None]
    pooled = torch.where(out_mask[:, None], pooled, PAD_COORD)
    if return_count:
        return pooled, out_mask, n_voxels
    return pooled, out_mask
