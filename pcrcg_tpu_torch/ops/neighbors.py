"""Fixed-capacity radius / k-NN search with static shapes.

Counterpart of ``pcrcg_tpu/ops/neighbors.py`` (reference nanoflann search,
cpp_neighbors/neighbors.cpp:211-332): support indices within ``radius``,
ascending distance, truncated to ``k`` and padded with the shadow index
``len(supports)``.  Squared distances use the ``|q|² + |s|² − 2 q·s``
expansion over query chunks.

The top-k is exact: a stable ascending sort, so equal distances keep the
lower index first, as ``lax.top_k`` orders them (the JAX package's
``approx_min_k`` lowers to that same exact top-k on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch


def radius_sq(radius: float) -> float:
    """radius² rounded as the JAX package rounds it (``float32(r) ** 2``)."""
    return float(np.float32(radius) ** 2)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a·b + c with one rounding, as a fused multiply-add gives it: the
    fp32 product is exact in fp64, so only the add rounds (fp64, then fp32;
    that differs from a true fma only on rare exact midpoints)."""
    return (a.double() * b.double() + c.double()).float()


def sq_norm(p: torch.Tensor) -> torch.Tensor:
    """|p|² over the last axis (3) as the fma chain z·z + (y·y + x·x)."""
    x, y, z = p.unbind(-1)
    return _fma(z, z, _fma(y, y, x * x))


def _sq_dists(q: torch.Tensor, sup_t: torch.Tensor, sup_sq: torch.Tensor) -> torch.Tensor:
    """[chunk,3] x [3,Ns] -> squared distances [chunk, Ns] (masked supports
    carry +inf through sup_sq), (|q|² + |s|²) − 2 q·s with |q|² and q·s as
    fma chains: the rounding of the JAX package's compiled XLA search on
    the CPU, so near-ties rank alike."""
    cross = _fma(q[:, 2, None], sup_t[2], _fma(q[:, 1, None], sup_t[1], q[:, 0, None] * sup_t[0]))
    return (sq_norm(q)[:, None] + sup_sq[None, :]) - 2.0 * cross


def _smallest_k(d2: torch.Tensor, k: int):
    """k smallest entries per row, ascending, lower index first on ties:
    (values, int64 indices)."""
    if k == 1:
        val, idx = d2.min(dim=-1, keepdim=True)  # first minimum on ties
        return val, idx
    val, idx = torch.sort(d2, dim=-1, stable=True)
    return val[..., :k], idx[..., :k]


def _support_terms(supports, support_mask):
    sup_sq = torch.where(support_mask, sq_norm(supports), torch.inf)
    return supports.T.contiguous(), sup_sq


def radius_search(queries, supports, support_mask, radius: float, k: int,
                  query_chunk: int = 1024) -> torch.Tensor:
    """queries [Nq,3], supports [Ns,3], support_mask [Ns] -> idx [Nq,k] int64
    in [0, Ns] (Ns = shadow), ascending distance."""
    ns = supports.shape[0]
    sup_t, sup_sq = _support_terms(supports, support_mask)
    r2 = radius_sq(radius)
    out = []
    for q in torch.split(queries, query_chunk):
        d2k, idx = _smallest_k(_sq_dists(q, sup_t, sup_sq), k)
        out.append(torch.where(d2k <= r2, idx, ns))
    return torch.cat(out)


def knn_search(queries, supports, support_mask, k: int, query_chunk: int = 1024):
    """k nearest valid supports per query, ascending: (idx [Nq,k] int64 with
    pad = Ns, squared distances [Nq,k])."""
    ns = supports.shape[0]
    sup_t, sup_sq = _support_terms(supports, support_mask)
    idxs, d2s = [], []
    for q in torch.split(queries, query_chunk):
        d2k, idx = _smallest_k(_sq_dists(q, sup_t, sup_sq), k)
        idxs.append(torch.where(torch.isfinite(d2k), idx, ns))
        d2s.append(d2k)
    return torch.cat(idxs), torch.cat(d2s)


def min_dist_sq(queries, supports, support_mask, query_chunk: int = 2048) -> torch.Tensor:
    """Per-query squared distance to the nearest valid support [Nq]."""
    sup_t, sup_sq = _support_terms(supports, support_mask)
    return torch.cat([
        _sq_dists(q, sup_t, sup_sq).amin(-1)
        for q in torch.split(queries, query_chunk)
    ])
