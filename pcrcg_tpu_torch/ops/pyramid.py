"""Multi-scale pyramid builder (counterpart of ``pcrcg_tpu/ops/pyramid.py``).

Per level ℓ: conv neighbors at radius r_ℓ, strided-pool points by grid
subsampling at dl = 2·r_ℓ/conv_radius, pool neighbors at r_ℓ and k=1
upsample neighbors at 2·r_ℓ, with r doubling per level (reference
datasets/dataloader.py:239,286-301,357).  Both clouds of a pair sit on a
leading [2, ...] axis.

``budgets.search_impl == "tiled"`` (the default): every search is the tiled
search of ``ops/tiled_search.py`` (K1 on the card), levels are subsampled in
Morton order, and the conv / pool searches also return the tile-local
metadata that the candidate-tile KPConv (K2) reads.  Any other value is the
reference route (pcrcg_tpu/ops/pyramid.py:152-167): raster-order
subsampling and the dense ``ops/neighbors.py::radius_search`` for conv,
pool and k = 1 upsample, with no tile-local metadata, so ``KPFCNN`` takes
the untiled KPConv route (K6 / K7 forward, K3's gathered entry backward).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pcrcg_tpu_torch.config import Budgets
from pcrcg_tpu_torch.ops.neighbors import radius_search
from pcrcg_tpu_torch.ops.subsample import grid_fits_morton, grid_subsample, morton_sort
from pcrcg_tpu_torch.ops.tiled_search import radius_search_tiled_batch


@dataclasses.dataclass
class Pyramid:
    """Static-shape pyramid for one pair of clouds.

    points[ℓ]:    [2, N_ℓ, 3]   (pad rows at PAD_COORD)
    masks[ℓ]:     [2, N_ℓ]      bool
    neighbors[ℓ]: [2, N_ℓ, H_ℓ] int64 conv neighbors within level ℓ (pad = N_ℓ)
    pools[ℓ]:     [2, N_{ℓ+1}, H_ℓ] neighbors of level-ℓ+1 queries in level ℓ
    upsamples[ℓ]: [2, N_ℓ, 1] nearest level-ℓ+1 point per level-ℓ query
    conv_local[ℓ] / pool_local[ℓ]: (lidx [2, G·128, H] int32,
                  tiles [2, G, M] int32) for the candidate-tile KPConv;
                  empty on the dense route
    """

    points: Tuple[torch.Tensor, ...]
    masks: Tuple[torch.Tensor, ...]
    neighbors: Tuple[torch.Tensor, ...]
    pools: Tuple[torch.Tensor, ...]
    upsamples: Tuple[torch.Tensor, ...]
    conv_local: Tuple = ()
    pool_local: Tuple = ()


def _subsample(points, mask, dl: float, n_out: int, tiled: bool = True):
    """Grid subsample both clouds.  Tiled: in Morton row order, and where a
    cloud's grid exceeds 1024 cells per axis the raster-ordered result is
    Z-sorted by its bounding box instead (selected on the device, no host
    sync).  Dense: in raster order."""
    pooled, pmask, counts = [], [], []
    for c in range(points.shape[0]):
        p, m, n = grid_subsample(points[c], mask[c], dl, n_out, return_count=True,
                                 order="morton" if tiled else "raster")
        if tiled:
            sp, sm, _ = morton_sort(p, m)
            fits = grid_fits_morton(points[c], mask[c], dl)
            p, m = torch.where(fits, p, sp), torch.where(fits, m, sm)
        pooled.append(p)
        pmask.append(m)
        counts.append(n)
    return torch.stack(pooled), torch.stack(pmask), torch.stack(counts)


def build_pyramid(
    points: torch.Tensor,
    mask: torch.Tensor,
    budgets: Budgets,
    first_subsampling_dl: float,
    conv_radius: float,
    with_overflow: bool = False,
    deform_conv: Optional[Tuple[bool, ...]] = None,
    deform_pool: Optional[Tuple[bool, ...]] = None,
    deform_scale: float = 2.0,
):
    """points [2, N_0, 3], mask [2, N_0] -> Pyramid (all levels).

    ``deform_conv[ℓ]`` / ``deform_pool[ℓ]`` widen the level-ℓ conv / pool
    search radius by ``deform_scale`` (reference dataloader.py:266-299).
    With ``with_overflow`` also returns overflow [num_levels-1, 2]: occupied
    voxels minus the level budget (positive = points dropped)."""
    num_levels = budgets.num_levels
    tile = budgets.search_tile
    tiled = budgets.search_impl == "tiled"

    def search(level, q, s, m, r, cap, mt=None, local=False):
        if not tiled:
            idx = torch.stack([radius_search(q[c], s[c], m[c], r, cap, budgets.query_chunk)
                               for c in range(q.shape[0])])
            return (idx, None, None) if local else idx
        mt = budgets.m_tiles_at(level) if mt is None else mt
        return radius_search_tiled_batch(q, s, m, r, cap, tile=tile, m_tiles=mt,
                                         return_local=local)

    r = first_subsampling_dl * conv_radius
    lvl_points, lvl_masks = [points], [mask]
    neighbors, pools, upsamples, overflow = [], [], [], []
    conv_local, pool_local = [], []
    with torch.no_grad():
        for level in range(num_levels):
            cap = budgets.neighbors[level]
            pts, msk = lvl_points[level], lvl_masks[level]
            r_conv = r * deform_scale if (deform_conv and deform_conv[level]) else r
            idx, lidx, tls = search(level, pts, pts, msk, r_conv, cap, local=True)
            neighbors.append(idx)
            if tiled:
                conv_local.append((lidx, tls))
            if level + 1 < num_levels:
                dl = 2.0 * r / conv_radius
                n_next = budgets.points[level + 1]
                pool_p, pool_m, n_voxels = _subsample(pts, msk, dl, n_next, tiled)
                overflow.append(n_voxels - n_next)
                r_pool = r * deform_scale if (deform_pool and deform_pool[level]) else r
                pidx, plidx, ptls = search(level, pool_p, pts, msk, r_pool, cap, local=True)
                pools.append(pidx)
                if tiled:
                    pool_local.append((plidx, ptls))
                # k=1 upsample: supports live at level+1 and, tiled, keep only
                # the 4 nearest candidate tiles (pcrcg_tpu/ops/pyramid.py:147-150).
                up_level = min(level + 1, num_levels - 1)
                upsamples.append(search(
                    up_level, pts, pool_p, pool_m, 2.0 * r, 1,
                    mt=min(4, budgets.m_tiles_at(up_level)),
                ))
                lvl_points.append(pool_p)
                lvl_masks.append(pool_m)
            r *= 2.0

    pyramid = Pyramid(
        points=tuple(lvl_points),
        masks=tuple(lvl_masks),
        neighbors=tuple(neighbors),
        pools=tuple(pools),
        upsamples=tuple(upsamples),
        conv_local=tuple(conv_local),
        pool_local=tuple(pool_local),
    )
    if with_overflow:
        return pyramid, torch.stack(overflow)
    return pyramid


def build_pyramid_cfg(cfg, points: torch.Tensor, mask: torch.Tensor, **kw):
    """build_pyramid with every geometry knob taken from a Config, including
    the deformable-architecture radius widening."""
    deform_conv, deform_pool = cfg.deform_level_flags()
    if not any(deform_conv) and not any(deform_pool):
        deform_conv = deform_pool = None
    return build_pyramid(
        points, mask, cfg.budgets, cfg.first_subsampling_dl, cfg.conv_radius,
        deform_conv=deform_conv, deform_pool=deform_pool,
        deform_scale=cfg.deform_radius / cfg.conv_radius, **kw,
    )
