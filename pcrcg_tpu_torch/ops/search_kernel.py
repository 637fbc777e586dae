"""Candidate-tile distance matrices for the tiled radius search (K1).

Counterpart of ``pcrcg_tpu/ops/search_kernel.py``.  Each 128-query group g
has ``M`` selected support tiles ``sel[g]``; the kernel writes

    d2[q, j] = (|q|² + |c_j|²) − 2·q·c_j

for the group's queries against its M·tile candidates, +inf where the
support is invalid.  On a CUDA tensor ``tiled_candidate_distances``
launches ``csrc/search_distances.cu``; on a CPU tensor it runs the plain
version below.  Both round as the JAX package's compiled XLA search does
on the CPU (``pcrcg_tpu/ops/tiled_search.py:116-120``): |q|², |c|² and
q·c as fused multiply-add chains over x, y, z (``ops/neighbors.py``).  So
the kernel reproduces the plain version, and the plain version ranks
near-tied neighbors as the JAX package does.
"""
from __future__ import annotations

import torch

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.ops.neighbors import _fma, sq_norm

_T = 128  # queries per group


def pack_supports_tile_major(supports: torch.Tensor, support_mask: torch.Tensor,
                             tile: int = 128) -> torch.Tensor:
    """supports [Ns_pad,3] (padded to a multiple of ``tile``), mask [Ns_pad]
    -> supa [n_tiles, 4, tile] f32: rows x, y, z, |c|² (+inf on invalid),
    one contiguous block per tile."""
    sq = torch.where(support_mask, sq_norm(supports), torch.inf)
    x, y, z = supports.unbind(-1)
    rows = torch.stack([x, y, z, sq])  # [4, Ns_pad]
    return rows.reshape(4, -1, tile).permute(1, 0, 2).contiguous()


def tiled_candidate_distances_plain(queries: torch.Tensor, supa: torch.Tensor,
                                    sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: -> d2 [G·128, M·tile]."""
    g_count, m_tiles = sel.shape
    tile = supa.shape[2]
    q = queries.new_zeros(g_count * _T, 3)
    q[: queries.shape[0]] = queries
    qg = q.view(g_count, _T, 3)
    cand = supa[sel.long()].permute(0, 2, 1, 3).reshape(g_count, 4, m_tiles * tile)
    qx, qy, qz = (qg[..., i, None] for i in range(3))  # [G, T, 1]
    cx, cy, cz, csq = (cand[:, None, i] for i in range(4))  # [G, 1, CAND]
    qsq = _fma(qz, qz, _fma(qy, qy, qx * qx))
    cross = _fma(qz, cz, _fma(qy, cy, qx * cx))
    d2 = (qsq + csq) - 2.0 * cross
    return d2.reshape(g_count * _T, m_tiles * tile)


def tiled_candidate_distances(queries: torch.Tensor, supa: torch.Tensor,
                              sel: torch.Tensor) -> torch.Tensor:
    """queries [Nq,3] f32 (Nq <= G·128; rows past Nq count as the origin),
    supa [n_tiles,4,tile] f32, sel [G,M] int32 -> d2 [G·128, M·tile] f32."""
    if queries.device.type == "cpu":
        return tiled_candidate_distances_plain(queries, supa, sel)
    dev = queries.device
    g_count, m_tiles = sel.shape
    n_tiles, rows, tile = supa.shape
    nq = queries.shape[0]
    if rows != 4 or nq > g_count * _T:
        raise ValueError(f"bad shapes: supa {tuple(supa.shape)}, {nq} queries for {g_count} groups")
    kernels.require(queries, "queries", torch.float32, dev, (nq, 3))
    kernels.require(supa, "supa", torch.float32, dev)
    kernels.require(sel, "sel", torch.int32, dev)
    d2 = torch.empty(g_count * _T, m_tiles * tile, device=dev, dtype=torch.float32)
    err = kernels.bind("search_distances", "pcrcg_tiled_distances", "pipipiiipp")(
        queries.data_ptr(), nq, supa.data_ptr(), n_tiles, sel.data_ptr(),
        g_count, m_tiles, tile, d2.data_ptr(), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "tiled_candidate_distances")
    kernels.count_launch("K1")
    return d2
