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

On the card ``build_pyramid_cfg`` replays the pyramid as one CUDA graph a
key (``graphed_pyramid``): its ~1,800 small kernels a pair then cost the
host one graph launch instead of one launch each.  Every shape in it is
static (each level's size is its budget) and nothing in it reads a value
back to the host, so the whole build captures.  The CPU runs it eagerly.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, Optional, Tuple

import torch

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.config import Budgets
from pcrcg_tpu_torch.ops.neighbors import radius_search
from pcrcg_tpu_torch.ops.subsample import grid_fits_morton, grid_subsample, morton_sort
from pcrcg_tpu_torch.ops.tiled_search import radius_search_tiled_batch
from pcrcg_tpu_torch.utils.profiling import counter_group, record, span, stage


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


def _build(points, mask, budgets: Budgets, first_subsampling_dl: float, conv_radius: float,
           deform_conv=None, deform_pool=None, deform_scale: float = 2.0):
    """The pyramid's device work: -> (Pyramid, overflow list by level,
    each [2]).  Records no counter, so it can be captured."""
    num_levels = budgets.num_levels
    tile = budgets.search_tile
    tiled = budgets.search_impl == "tiled"

    def search(level, q, s, m, r, cap, mt=None, local=False):
        with span("pyramid.search"):
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
                with span("pyramid.subsample"):
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
    return pyramid, overflow


def _record_counters(pyramid: Pyramid, overflow) -> None:
    """The counters ``pyramid.real_points`` / ``pyramid.budget_rows`` (by
    level, both clouds) and ``pyramid.dropped_voxels`` (by the level
    subsampled from: the overflow's positive part), from a built pyramid."""
    for level, m in enumerate(pyramid.masks):
        record("pyramid.real_points", level, m)
        record("pyramid.budget_rows", level, m.numel())
    for level, o in enumerate(overflow):
        record("pyramid.dropped_voxels", level, o)


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
    """points [2, N_0, 3], mask [2, N_0] -> Pyramid (all levels), built
    eagerly.

    ``deform_conv[ℓ]`` / ``deform_pool[ℓ]`` widen the level-ℓ conv / pool
    search radius by ``deform_scale`` (reference dataloader.py:266-299).
    With ``with_overflow`` also returns overflow [num_levels-1, 2]: occupied
    voxels minus the level budget (positive = points dropped).

    Traced (``utils/profiling.py``): the parts ``pyramid.subsample`` and
    ``pyramid.search`` of the stage ``pyramid``, and the counters of
    ``_record_counters``."""
    pyramid, overflow = _build(points, mask, budgets, first_subsampling_dl, conv_radius,
                               deform_conv, deform_pool, deform_scale)
    _record_counters(pyramid, overflow)
    if with_overflow:
        return pyramid, torch.stack(overflow)
    return pyramid


# ---- One CUDA graph a key ---------------------------------------------------

# Calls on the card (group "pyramid_graph" of utils/profiling.py::counters):
# first calls with a key, which captured its graph; later calls, which
# replayed one; calls that ran eagerly (made inside another capture, or with
# a key whose capture failed).
GRAPH_CALLS: Dict[str, int] = counter_group("pyramid_graph", ("captures", "replays", "eager"))

_WARMUP = 2  # eager builds on a side stream before a capture (torch.cuda.graph's rule)
_ALIGN = 256  # bytes: every output starts on an allocator-aligned offset
_LOG = logging.getLogger(__name__)


def graph_key(points, mask, budgets: Budgets, first_subsampling_dl: float,
              conv_radius: float, with_overflow: bool = False, deform_conv=None,
              deform_pool=None, deform_scale: float = 2.0) -> tuple:
    """Everything the pyramid's kernels depend on: the device, the inputs'
    shapes and dtypes, the budgets and every geometry knob."""
    return (points.device, tuple(points.shape), points.dtype, tuple(mask.shape), mask.dtype,
            budgets, float(first_subsampling_dl), float(conv_radius), bool(with_overflow),
            None if deform_conv is None else tuple(deform_conv),
            None if deform_pool is None else tuple(deform_pool), float(deform_scale))


def _leaves(pyramid: Pyramid):
    """The pyramid's tensors in field order (a tile-local entry gives two)."""
    return [t for f in dataclasses.fields(Pyramid) for item in getattr(pyramid, f.name)
            for t in (item if isinstance(item, tuple) else (item,))]


def _shape_of(pyramid: Pyramid) -> dict:
    """Per field, each entry's tensor count (None: a tensor, not a tuple)."""
    return {f.name: tuple(len(item) if isinstance(item, tuple) else None
                          for item in getattr(pyramid, f.name))
            for f in dataclasses.fields(Pyramid)}


def _from_leaves(shape: dict, leaves) -> Pyramid:
    it = iter(leaves)
    return Pyramid(**{name: tuple(next(it) if n is None else tuple(next(it) for _ in range(n))
                                  for n in counts)
                      for name, counts in shape.items()})


class _Graph:
    """The pyramid of one key, captured: static inputs (the points and the
    mask), the graph, and every output but the inputs packed in one byte
    buffer inside it, so a replay hands back its pyramid with one copy and
    the next replay cannot overwrite it."""

    def __init__(self, points, mask, knobs: dict):
        dev = points.device
        self.points = points.clone(memory_format=torch.contiguous_format)
        self.mask = mask.clone(memory_format=torch.contiguous_format)
        launched = dict(kernels.LAUNCHES)
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP):
                    _build(self.points, self.mask, **knobs)
            torch.cuda.current_stream(dev).wait_stream(side)
            before = dict(kernels.LAUNCHES)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA calls (a loader's upload)
            # neither fail nor invalidate the capture.
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                pyramid, overflow = _build(self.points, self.mask, **knobs)
                self._pack(_leaves(pyramid) + [torch.stack(overflow)])
            # What one call launches: each replay adds it, as an eager call
            # would (the warm-ups and the capture add nothing).
            self.launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        finally:
            kernels.LAUNCHES.update(launched)
        self.shape = _shape_of(pyramid)

    def _pack(self, outputs) -> None:
        """Copy the outputs into one buffer (inside the capture); the static
        inputs are left out, a replay hands back the caller's own."""
        self.layout, offset = [], 0
        for t in outputs:
            if t is self.points or t is self.mask:
                self.layout.append(t is self.points)
                continue
            nbytes = t.numel() * t.element_size()
            self.layout.append((offset, nbytes, t.dtype, tuple(t.shape)))
            offset += -(-nbytes // _ALIGN) * _ALIGN
        self.packed = torch.empty(offset, dtype=torch.uint8, device=self.points.device)
        for t, at in zip(outputs, self.layout):
            if isinstance(at, tuple):
                self._view(self.packed, at).copy_(t)

    @staticmethod
    def _view(buf, at):
        offset, nbytes, dtype, shape = at
        return buf[offset:offset + nbytes].view(dtype).view(shape)

    def __call__(self, points, mask):
        """Replay on the current stream -> (Pyramid, overflow), owned by
        the caller."""
        self.points.copy_(points)
        self.mask.copy_(mask)
        self.graph.replay()
        out = self.packed.clone()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        leaves = [(points if at else mask) if isinstance(at, bool) else self._view(out, at)
                  for at in self.layout]
        return _from_leaves(self.shape, leaves[:-1]), leaves[-1]


_GRAPHS: Dict[tuple, _Graph] = {}  # by graph_key; the process's, as CUDA's own caches
_FAILED: set = set()  # keys whose capture failed: they run eagerly
_LOCK = threading.Lock()  # one capture or replay at a time uses a graph's buffers


def graphed_pyramid(points, mask, budgets: Budgets, first_subsampling_dl: float,
                    conv_radius: float, with_overflow: bool = False, deform_conv=None,
                    deform_pool=None, deform_scale: float = 2.0):
    """``build_pyramid`` on the card, as a CUDA graph: the first call with a
    key (``graph_key``) captures it, later calls replay it.  Bit for bit
    the eager build; the counters are recorded from what it returns.  A
    call made while a capture is under way, or with a key whose capture
    failed, runs eagerly."""
    knobs = dict(budgets=budgets, first_subsampling_dl=first_subsampling_dl,
                 conv_radius=conv_radius, deform_conv=deform_conv, deform_pool=deform_pool,
                 deform_scale=deform_scale)
    key = graph_key(points, mask, with_overflow=with_overflow, **knobs)
    if torch.cuda.is_current_stream_capturing() or key in _FAILED:
        GRAPH_CALLS["eager"] += 1
        return build_pyramid(points, mask, with_overflow=with_overflow, **knobs)
    with _LOCK:
        graph = _GRAPHS.get(key)
        if graph is None:
            try:
                graph = _Graph(points, mask, knobs)
            except RuntimeError:
                _LOG.warning("pyramid: capture failed for %s, running eagerly", key,
                             exc_info=True)
                _FAILED.add(key)
                GRAPH_CALLS["eager"] += 1
                return build_pyramid(points, mask, with_overflow=with_overflow, **knobs)
            _GRAPHS[key] = graph
            GRAPH_CALLS["captures"] += 1
        else:
            GRAPH_CALLS["replays"] += 1
        pyramid, overflow = graph(points, mask)
    _record_counters(pyramid, overflow)
    return (pyramid, overflow) if with_overflow else pyramid


def clear_graphs() -> None:
    """Drop every captured pyramid and failed key (their memory with them)."""
    with _LOCK:
        _GRAPHS.clear()
        _FAILED.clear()


def build_pyramid_cfg(cfg, points: torch.Tensor, mask: torch.Tensor, **kw):
    """build_pyramid with every geometry knob taken from a Config, including
    the deformable-architecture radius widening; traced as the stage
    ``pyramid``.  On the card, as a CUDA graph (``graphed_pyramid``)."""
    deform_conv, deform_pool = cfg.deform_level_flags()
    if not any(deform_conv) and not any(deform_pool):
        deform_conv = deform_pool = None
    build = graphed_pyramid if points.device.type == "cuda" else build_pyramid
    with stage("pyramid"):
        return build(
            points, mask, cfg.budgets, cfg.first_subsampling_dl, cfg.conv_radius,
            deform_conv=deform_conv, deform_pool=deform_pool,
            deform_scale=cfg.deform_radius / cfg.conv_radius, **kw,
        )
