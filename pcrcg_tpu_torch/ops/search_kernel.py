"""The tiled radius search over the selected candidate tiles (K1).

Counterpart of ``pcrcg_tpu/ops/search_kernel.py`` and of the top-k, index
mapping and radius cutoff that follow it in
``pcrcg_tpu/ops/tiled_search.py::radius_search_tiled_batch``.  Each
128-query group g has ``M`` selected support tiles ``sel[g]``; for its
queries against its M·tile candidates

    d2[q, j] = (|q|² + |c_j|²) − 2·q·c_j        (+inf where c_j is invalid)

and ``tiled_search`` keeps the k smallest (d2, j) per query, ascending
(lower candidate position j first on ties, as a stable sort and
``lax.top_k`` order them), within the radius: idx (per-cloud support
index, shadow Ns) and lidx (j, shadow M·tile).  ``tiled_min_dist_sq`` is
the value mode: each query's smallest d2.  On a CUDA tensor both launch
``csrc/search_distances.cu``, which never writes the distance matrix; on a
CPU tensor they run the plain chain below (distances, ``_smallest_k``,
mapping, cutoff).  Both round as the JAX package's compiled XLA search does
on the CPU (``pcrcg_tpu/ops/tiled_search.py:116-120``): |q|², |c|² and q·c
as fused multiply-add chains over x, y, z (``ops/neighbors.py``).  So the
kernel reproduces the plain chain index for index, and the plain chain
ranks near-tied neighbors as the JAX package does.
"""
from __future__ import annotations

import torch

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.ops.neighbors import _fma, _smallest_k, sq_norm

_T = 128  # queries per group
_MAX_SMEM = 232448  # shared-memory bytes a block may use on the H100
_MODES = {"topk": 0, "nearest": 1, "min_d2": 2}


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
    """The distance arithmetic of the kernel, in plain PyTorch:
    -> d2 [G·128, M·tile]."""
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


def _check_search(queries, supa, sel, k, batch):
    """Shapes both versions need; -> (g_count a cloud, n_tiles a cloud)."""
    g_total, m_tiles = sel.shape
    n_rows, rows, tile = supa.shape
    if rows != 4 or queries.shape != (g_total * _T, 3):
        raise ValueError(f"bad shapes: supa {tuple(supa.shape)}, queries "
                         f"{tuple(queries.shape)} for {g_total} groups")
    if batch < 1 or g_total % batch or n_rows % batch:
        raise ValueError(f"{g_total} groups and {n_rows} tiles do not split into {batch} clouds")
    if not 1 <= k <= m_tiles * tile:
        raise ValueError(f"k = {k} outside 1 .. {m_tiles * tile} candidates")
    return g_total // batch, n_rows // batch


def tiled_search_plain(queries, supa, sel, k: int, r2: float, nq: int, ns: int, batch: int = 1):
    """Plain PyTorch version of the kernel: the distances, a stable sort
    (``_smallest_k``), the tile-table mapping and the radius cutoff, as the
    JAX package's ``radius_search_tiled_batch`` runs them."""
    g_count, n_tiles = _check_search(queries, supa, sel, k, batch)
    m_tiles, tile = sel.shape[1], supa.shape[2]
    nq_pad = g_count * _T
    d2k, lidx = _smallest_k(tiled_candidate_distances_plain(queries, supa, sel), k)
    d2k = d2k.reshape(batch, nq_pad, k)
    lidx = lidx.reshape(batch, g_count, _T * k)
    boff = torch.arange(batch, device=sel.device)[:, None, None] * n_tiles
    cloud_sel = sel.long().reshape(batch, g_count, m_tiles) - boff  # per-cloud tile ids
    tile_of = torch.gather(cloud_sel, 2, lidx // tile)
    gidx = (tile_of * tile + lidx % tile).reshape(batch, nq_pad, k)
    lidx = lidx.reshape(batch, nq_pad, k)
    in_r = d2k <= r2
    idx = torch.where(in_r, gidx, ns)[:, :nq]
    return idx, torch.where(in_r, lidx, m_tiles * tile).to(torch.int32)


def tiled_search(queries, supa, sel, k: int, r2: float, nq: int, ns: int, batch: int = 1):
    """K1: queries [B·G·128, 3] f32 (each cloud's queries padded to G
    groups), supa [B·n_tiles, 4, tile] f32, sel [B·G, M] int32 (tile ids of
    the stacked clouds), k, r2 = radius² (fp32), nq and ns a cloud ->
    (idx [B, nq, k] int64 in [0, ns], lidx [B, G·128, k] int32 in
    [0, M·tile])."""
    if queries.device.type == "cpu":
        return tiled_search_plain(queries, supa, sel, k, r2, nq, ns, batch)
    g_count = _check_search(queries, supa, sel, k, batch)[0]
    idx = torch.empty(batch, nq, k, device=queries.device, dtype=torch.int64)
    lidx = torch.empty(batch, g_count * _T, k, device=queries.device, dtype=torch.int32)
    _launch(queries, supa, sel, k, r2, nq, ns, batch, "nearest" if k == 1 else "topk",
            idx, lidx, None)
    return idx, lidx


def tiled_min_dist_sq_plain(queries, supa, sel, nq: int):
    """Plain PyTorch version of the value mode: d2.amin(-1)[:nq]."""
    _check_search(queries, supa, sel, 1, 1)
    return tiled_candidate_distances_plain(queries, supa, sel).amin(-1)[:nq]


def tiled_min_dist_sq(queries, supa, sel, nq: int):
    """K1, value mode, one cloud: queries [G·128, 3], supa [n_tiles, 4,
    tile], sel [G, M] int32 -> each query's smallest d2 over its group's
    candidates [nq] (no cutoff), bit for bit the plain ``amin``."""
    if queries.device.type == "cpu":
        return tiled_min_dist_sq_plain(queries, supa, sel, nq)
    out = torch.empty(nq, device=queries.device, dtype=torch.float32)
    _launch(queries, supa, sel, 1, 0.0, nq, 0, 1, "min_d2", None, None, out)
    return out


def _launch(queries, supa, sel, k, r2, nq, ns, batch, mode, idx, lidx, min_d2):
    dev = queries.device
    g_count, n_tiles = _check_search(queries, supa, sel, k, batch)
    m_tiles, tile = sel.shape[1], supa.shape[2]
    kernels.require(queries, "queries", torch.float32, dev)
    kernels.require(supa, "supa", torch.float32, dev)
    kernels.require(sel, "sel", torch.int32, dev)
    need = kernels.bind("search_distances", "pcrcg_tiled_search_smem", "iiii")(
        m_tiles, tile, k, _MODES[mode])
    if need > _MAX_SMEM:
        raise ValueError(f"{m_tiles} tiles of {tile} candidates and k = {k} need {need} B of "
                         f"shared memory, over the {_MAX_SMEM} B of a block")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = kernels.bind("search_distances", "pcrcg_tiled_search", "pppiiiiiiiifipppp")(
        queries.data_ptr(), supa.data_ptr(), sel.data_ptr(), sel.shape[0], g_count, m_tiles,
        tile, n_tiles, nq, ns, k, float(r2), _MODES[mode], ptr(idx), ptr(lidx), ptr(min_d2),
        kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "tiled_search")
    kernels.count_launch("K1")
