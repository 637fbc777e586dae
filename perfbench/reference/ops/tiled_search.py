"""Frozen plain copy of the port's ``ops/tiled_search.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

Tile-pruned radius search: Morton-local support tiles + box pruning.

Counterpart of ``pcrcg_tpu/ops/tiled_search.py``.  Queries and supports are
Z-order sorted, so 128-query groups and ``tile``-row support tiles are
spatially compact.  Each group keeps its ``m_tiles`` nearest tiles (box
distance first, box-center distance as tie-break), and the exact search
runs against just those candidates (``ops/search_kernel.py``'s plain
chain; the port's K1 launch) takes the distances, the exact top-k, the radius
cutoff and the local -> global mapping, and writes no distance matrix.
When the tile grid is too small to prune (``n_tiles <= m_tiles``) the
dense search runs instead and the local metadata lists every tile.

There is one route: every tiled search goes through
``radius_search_tiled_batch`` (the per-cloud ``radius_search_tiled`` is a
batch of one).
"""
from __future__ import annotations

import torch

from perfbench.reference.ops.masked import PAD_COORD
from perfbench.reference.ops.neighbors import min_dist_sq, radius_search, radius_sq
from perfbench.reference.ops.search_kernel import (
    pack_supports_tile_major, tiled_min_dist_sq, tiled_search,
)

_Q_TILE = 128  # queries per pruning group


def _pad_rows(x: torch.Tensor, multiple: int, fill, dim: int = 0) -> torch.Tensor:
    """Pad ``dim`` of x up to a multiple of ``multiple`` with ``fill``."""
    rem = (-x.shape[dim]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[dim] = rem
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim)


def _tile_boxes(sup_tiles: torch.Tensor, tmask: torch.Tensor):
    """Per-tile AABB, center and validity from [..., n_tiles, tile, 3]."""
    m = tmask[..., None]
    tmin = torch.where(m, sup_tiles, PAD_COORD).amin(-2)
    tmax = torch.where(m, sup_tiles, -PAD_COORD).amax(-2)
    return tmin, tmax, 0.5 * (tmin + tmax), tmask.any(-1)


def _group_tile_selection(q_groups, tmin, tmax, tctr, tile_valid, m_tiles: int):
    """q_groups [B, G, 128, 3], tile boxes [B, n_tiles, 3], tile_valid
    [B, n_tiles] -> sel [B, G, m_tiles] int32: the nearest tiles first,
    lower tile id first on equal scores (as ``lax.top_k`` orders them)."""
    qvalid = (q_groups[..., 0].abs() < PAD_COORD * 0.5)[..., None]
    qmin = torch.where(qvalid, q_groups, PAD_COORD).amin(-2)  # [B, G, 3]
    qmax = torch.where(qvalid, q_groups, -PAD_COORD).amax(-2)
    qctr = 0.5 * (qmin + qmax)
    gap = torch.maximum(
        torch.maximum(
            tmin[:, None, :, :] - qmax[:, :, None, :],
            qmin[:, :, None, :] - tmax[:, None, :, :],
        ),
        torch.zeros((), device=q_groups.device),
    )  # [B, G, n_tiles, 3]
    score = (gap * gap).sum(-1) + 1e-3 * ((tctr[:, None] - qctr[:, :, None]) ** 2).sum(-1)
    score = torch.where(tile_valid[:, None, :], score, torch.inf)
    sel = torch.sort(score, dim=-1, stable=True).indices[..., :m_tiles]
    return sel.to(torch.int32)


def _dense_fallback(queries, supports, support_mask, radius, k, tile, n_tiles, return_local):
    b, nq = queries.shape[:2]
    ns = supports.shape[1]
    idx = torch.stack([
        radius_search(queries[i], supports[i], support_mask[i], radius, k)
        for i in range(b)
    ])
    if not return_local:
        return idx
    g_count = (nq + _Q_TILE - 1) // _Q_TILE
    idx_p = _pad_rows(idx, _Q_TILE, ns, dim=1)
    lidx = torch.where(idx_p == ns, n_tiles * tile, idx_p).to(torch.int32)
    tiles = torch.arange(n_tiles, dtype=torch.int32, device=queries.device)
    return idx, lidx, tiles.expand(b, g_count, n_tiles).contiguous()


def radius_search_tiled_batch(
    queries: torch.Tensor,  # [B, Nq, 3] (Z-order sorted per cloud)
    supports: torch.Tensor,  # [B, Ns, 3] (Z-order sorted per cloud)
    support_mask: torch.Tensor,  # [B, Ns]
    radius: float,
    k: int,
    tile: int = 128,
    m_tiles: int = 16,
    return_local: bool = False,
):
    """Batched tiled search, all B clouds in one K1 launch (the clouds stack
    with per-cloud tile-id offsets).  Returns idx [B, Nq, k] int64 in
    [0, Ns] (Ns = shadow), ascending distance; with ``return_local`` also
    lidx [B, G·128, k] int32 (position inside the group's candidate block,
    shadow = m_tiles·tile) and tiles [B, G, m_tiles] int32 (per-cloud tile
    ids; all tiles on the dense fallback)."""
    b, nq = queries.shape[:2]
    ns = supports.shape[1]
    sup = _pad_rows(supports, tile, PAD_COORD, dim=1)
    smask = _pad_rows(support_mask, tile, False, dim=1)
    n_tiles = sup.shape[1] // tile
    if n_tiles <= m_tiles:
        return _dense_fallback(queries, supports, support_mask, radius, k, tile,
                               n_tiles, return_local)

    tmin, tmax, tctr, tile_valid = _tile_boxes(
        sup.reshape(b, n_tiles, tile, 3), smask.reshape(b, n_tiles, tile)
    )
    g_count = (nq + _Q_TILE - 1) // _Q_TILE
    nq_pad = g_count * _Q_TILE
    qpad = _pad_rows(queries, _Q_TILE, PAD_COORD, dim=1)
    sel = _group_tile_selection(
        qpad.reshape(b, g_count, _Q_TILE, 3), tmin, tmax, tctr, tile_valid, m_tiles
    )  # [B, G, M]

    boff = (torch.arange(b, dtype=torch.int32, device=sel.device) * n_tiles)[:, None, None]
    supa = pack_supports_tile_major(
        sup.reshape(b * n_tiles * tile, 3), smask.reshape(-1), tile
    )  # [B·n_tiles, 4, tile]
    idx, lidx = tiled_search(
        qpad.reshape(b * nq_pad, 3).contiguous(), supa,
        (sel + boff).reshape(b * g_count, m_tiles).contiguous(), k, radius_sq(radius), nq, ns, b,
    )
    if not return_local:
        return idx
    return idx, lidx, sel


def radius_search_tiled(queries, supports, support_mask, radius: float, k: int,
                        tile: int = 128, m_tiles: int = 16, return_local: bool = False):
    """One cloud: queries [Nq,3], supports [Ns,3], mask [Ns] -> idx [Nq,k]
    (+ lidx [G·128,k], tiles [G,M] with ``return_local``)."""
    out = radius_search_tiled_batch(
        queries[None], supports[None], support_mask[None], radius, k,
        tile=tile, m_tiles=m_tiles, return_local=return_local,
    )
    if return_local:
        return tuple(t[0] for t in out)
    return out[0]


def min_dist_sq_tiled(queries, supports, support_mask, tile: int = 128,
                      m_tiles: int = 16) -> torch.Tensor:
    """Per-query squared distance to the nearest valid support among the
    group's m_tiles candidate tiles [Nq].  Safe only for thresholded use
    (``min_d2 <= r²``): a nearest support outside the candidates can only
    make the value too large, and then the true one exceeds any small r."""
    nq = queries.shape[0]
    sup = _pad_rows(supports, tile, PAD_COORD)
    smask = _pad_rows(support_mask, tile, False)
    n_tiles = sup.shape[0] // tile
    if n_tiles <= m_tiles:
        return min_dist_sq(queries, supports, support_mask)
    tmin, tmax, tctr, tile_valid = _tile_boxes(
        sup.reshape(1, n_tiles, tile, 3), smask.reshape(1, n_tiles, tile)
    )
    g_count = (nq + _Q_TILE - 1) // _Q_TILE
    qpad = _pad_rows(queries, _Q_TILE, PAD_COORD)
    sel = _group_tile_selection(
        qpad.reshape(1, g_count, _Q_TILE, 3), tmin, tmax, tctr, tile_valid, m_tiles
    )[0]
    return tiled_min_dist_sq(qpad.contiguous(), pack_supports_tile_major(sup, smask, tile),
                             sel.contiguous(), nq)
