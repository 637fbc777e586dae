"""Kernel-point convolution (counterpart of ``pcrcg_tpu/models/kpconv.py``).

``conv_route`` picks each conv's route, the one place that does; ``KPConv``
dispatches on it, and its docstring holds the route table.  The functional
``kpconv(impl=)`` is the JAX package's ``kpconv``, on a route without tile
metadata; its ``dense`` route (``_dense``) is the reference the kernels are
tested against.  The untiled routes' gathers are ``index_select``s whose
backward is an ``index_add_``.

``kpconv_deformable`` (reference blocks.py:235-372) is the dense
formulation against per-query kernel points, plain PyTorch as in the JAX
package (pcrcg_tpu/models/kpconv.py:253-334).  Traced
(``utils/profiling.py``): the spans ``deform.offset`` (the offset sub-conv
and its bias) and ``deform.conv``, and by query level the counters
``deform.real_neighbors`` (non-shadow list entries),
``deform.kept_neighbors`` (those within KP_extent of some deformed kernel
point: what the conv keeps) and ``deform.cap_rows`` (Nq·H).
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from pcrcg_tpu_torch.geom.kernel_points import layer_kernel_points
from pcrcg_tpu_torch.ops import kpconv_fused, kpconv_pallas
from pcrcg_tpu_torch.ops.kpconv_common import influence_fn
from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled_ad, max_pool_tiled
from pcrcg_tpu_torch.ops.masked import PAD_COORD, pad_gather, pad_gather_rows
from pcrcg_tpu_torch.utils.profiling import record, recording, span

IMPLS = ("fused", "reduce", "xla")


# ``conv``: the route (``KPConv``'s table); ``shortcut``: a strided conv's
# rule (``max_pool_first``, ``merged``, ``max_pool``), else None;
# ``shared_rel``: the conv reads its level's rel (``KPFCNN``).
ConvRoute = collections.namedtuple("ConvRoute", "conv shortcut shared_rel")


def conv_route(impl: str = "auto", tiled: bool = True, aggregation: str = "sum", *,
               strided: bool = False, deformable: bool = False, in_channels: int = 0,
               tiled_pyramid: bool = False, backward: bool = False) -> ConvRoute:
    """The route of one conv (``KPConv``'s table) from the config's
    ``kpconv_impl`` (``auto`` -> ``fused``; the JAX package takes ``xla``
    off the TPU), ``kpconv_tiled`` and aggregation, the block's
    ``strided``, ``deformable`` and ``in_channels``, and ``tiled_pyramid``
    (the pyramid carries tile metadata).  ``backward`` refuses ``reduce``.
    Shortcuts and shared rels as pcrcg_tpu/models/blocks.py:182-229 and
    kpfcnn.py:191-208, but a deformable conv on a tile pyramid takes
    ``max_pool_first`` (the JAX package ``max_pool``: they differ only in
    how a gradient splits among exactly tied maxima)."""
    impl = "fused" if impl == "auto" else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown kpconv_impl {impl!r}: one of auto, {', '.join(IMPLS)}")
    if backward and impl == "reduce":
        raise NotImplementedError(
            "kpconv_impl='reduce' serves only: its kernel (K8, pcrcg_tpu/ops/kpconv_pallas.py)"
            " has no backward, and the JAX package defines no VJP for it"
        )
    tile_route = impl == "fused" and tiled and tiled_pyramid
    if deformable:
        conv = "deformable"
    elif tile_route:
        conv = "tiled"
    elif impl == "fused":
        conv = "merged" if strided else "gathered"
    elif impl == "reduce" and aggregation == "sum" and in_channels >= 8:
        conv = "reduce"
    else:
        conv = "dense"
    if not strided:
        return ConvRoute(conv, None, conv != "tiled")
    shortcut = "max_pool_first" if tile_route else "merged" if conv == "merged" else "max_pool"
    return ConvRoute(conv, shortcut, impl != "fused")


def max_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """x [Ns, C], inds [Nq, H] (pad >= Ns) -> [Nq, C]: the max over the
    neighbors, a shadow contributing a zero row (reference blocks.py:86-103).
    Its gradient splits evenly among tied maxima (``amax``, as ``jnp.max``'s
    VJP): the rule of the JAX package's untiled routes
    (pcrcg_tpu/models/blocks.py:45-50)."""
    return pad_gather_rows(x, inds).amax(1)


def max_pool_first(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """The tile route's strided shortcut: x [B,Ns,C], inds [B,Nq,H] (pad =
    Ns) -> [B,Nq,C]; shadow neighbors contribute a zero row.  The B clouds
    stack into one ``max_pool_tiled`` call, whose gradient goes to the
    first maximal neighbor (K5 on the card), as the JAX package's tiled
    route does (pcrcg_tpu/models/blocks.py:195-211)."""
    b, ns, c = x.shape
    nq = inds.shape[1]
    return max_pool_tiled(x.reshape(b * ns, c), stack_inds(inds, ns)).reshape(b, nq, c)


def _dense(neighbors, neighb_x, kernel_points, weights, kp_extent, influence, aggregation):
    """The plain formulation (reference models/blocks.py:284-372) on
    gathered rel [Nq, H, 3] (shadows at PAD_COORD: zero influence) and
    features [Nq, H, C] (shadows 0) -> [Nq, D]: influences against the K
    kernel points, the weighted reduce over neighbors, one [K·C] x [K·C, D]
    contraction, over the reference's positive-feature-sum neighbor count."""
    diff = neighbors[:, :, None, :] - kernel_points[None, None, :, :]
    sq_distances = (diff * diff).sum(-1)  # [Nq,H,K]
    all_weights = influence_fn(sq_distances, kp_extent, influence)
    if aggregation == "closest":
        nearest = sq_distances.argmin(-1)
        all_weights = all_weights * nn.functional.one_hot(
            nearest, kernel_points.shape[0]
        ).to(all_weights.dtype)
    elif aggregation != "sum":
        raise ValueError(f"Unknown aggregation mode: {aggregation}")
    weighted = torch.einsum("nhk,nhc->nkc", all_weights, neighb_x)
    out = weighted.reshape(weighted.shape[0], -1) @ weights.reshape(-1, weights.shape[-1])
    neighbor_num = (neighb_x.sum(-1) > 0.0).sum(-1).clamp_min(1)
    return out / neighbor_num[:, None].to(out.dtype)


def _merged(q_pts, s_pts, neighb_inds, x, shortcut_x, kernel_points, weights, kp_extent,
            influence, aggregation, ones_features):
    """The strided conv and its shortcut from ONE gather (K7)."""
    feats = torch.ones_like(s_pts[:, :1]) if ones_features else x
    base = torch.cat([s_pts, s_pts.new_zeros(s_pts.shape[0], 5), feats, shortcut_x], 1)
    nxc = pad_gather_rows(base, neighb_inds)  # [Nq, H, 8 + C1 + C2]
    c8 = 8 + feats.shape[1]
    w8 = torch.cat([weights.new_zeros(weights.shape[0], 8, weights.shape[2]), weights], 1)
    out, neighbor_num = kpconv_fused.kpconv_fused_merged_ad(
        q_pts.contiguous(), nxc[:, :, :c8].permute(1, 2, 0).contiguous(), kernel_points, w8,
        kp_extent, influence, aggregation, needs_dnx=not ones_features,
    )
    return out / neighbor_num[:, None], nxc[:, :, c8:].amax(1)


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent: float,
           influence: str = "linear", aggregation: str = "sum", neighbors_rel=None,
           ones_features: bool = False, impl: str = "xla", shortcut_x=None):
    """q_pts [Nq,3], s_pts [Ns,3], neighb_inds [Nq,H] (pad = Ns), x [Ns,C],
    kernel_points [K,3], weights [K,C,D] -> [Nq,D], on ``impl``'s route
    without tile metadata (``conv_route``).

    ``neighbors_rel`` [Nq,H,3] (gathered neighbor coordinates minus query)
    may be computed once per pyramid level and shared by its convs.  With
    ``shortcut_x`` [Ns, C2] it also returns, second, the strided block's
    max-pooled shortcut ``max_h shortcut_x[neighbor]`` (zero shadow rows):
    on ``merged`` from the conv's own gather, else ``max_pool``."""
    conv = conv_route(impl, False, aggregation, strided=shortcut_x is not None,
                      in_channels=x.shape[-1]).conv
    if conv == "merged":
        return _merged(q_pts, s_pts, neighb_inds, x, shortcut_x, kernel_points, weights,
                       kp_extent, influence, aggregation, ones_features)
    if neighbors_rel is None:
        neighbors_rel = pad_gather(s_pts, neighb_inds, fill_value=PAD_COORD) - q_pts[:, None, :]
    # Ones-column input: the gathered feature is "neighbor index is real".
    nx = (neighb_inds < x.shape[0]).to(x.dtype)[..., None] if ones_features else None

    if conv == "gathered":
        nx = pad_gather_rows(x, neighb_inds) if nx is None else nx
        out, neighbor_num = kpconv_fused.kpconv_fused_ad(
            neighbors_rel.contiguous(), nx.permute(1, 2, 0).contiguous(), kernel_points,
            weights, kp_extent, influence, aggregation, needs_dnx=not ones_features,
        )
        out = out / neighbor_num[:, None]
    elif conv == "reduce":
        nx = pad_gather_rows(x, neighb_inds) if nx is None else nx
        weighted, neighbor_num = kpconv_pallas.kpconv_weighted_reduce(
            neighbors_rel.contiguous(), nx.contiguous(), kernel_points, kp_extent, influence,
        )  # weighted [K, Nq, C]
        k_count, nq, c_in = weighted.shape
        out = weighted.transpose(0, 1).reshape(nq, k_count * c_in) @ weights.reshape(
            k_count * c_in, -1)
        out = out / neighbor_num[:, None]
    else:
        if nx is None:
            nx = pad_gather(x, neighb_inds, fill_value=0.0)  # [Nq,H,C]
        out = _dense(neighbors_rel, nx, kernel_points, weights, kp_extent, influence,
                     aggregation)
    return out if shortcut_x is None else (out, max_pool(shortcut_x, neighb_inds))


def kpconv_deformable(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent: float,
                      offsets, modulations=None, influence: str = "linear",
                      aggregation: str = "sum", level: int = 0):
    """Deformable KPConv over one point set: as ``kpconv``, with the kernel
    points of query n at ``kernel_points + offsets[n]`` (offsets [Nq, K, 3],
    already scaled by KP_extent) and the weighted features of kernel point k
    multiplied by ``modulations[n, k]`` when given ([Nq, K]).

    The reference prunes, per query, the neighbors farther than KP_extent
    from every deformed kernel point and re-pads them as shadows
    (blocks.py:292-316); with static shapes their influences are zeroed and
    they leave the neighbor count, which gives the same output for every
    influence and aggregation.  ``level`` indexes the ``deform.*``
    counters."""
    neighbors = pad_gather(s_pts, neighb_inds, fill_value=PAD_COORD) - q_pts[:, None, :]
    deformed = kernel_points[None, :, :] + offsets  # [Nq,K,3]
    diff = neighbors[:, :, None, :] - deformed[:, None, :, :]
    sq_distances = (diff * diff).sum(-1)  # [Nq,H,K]
    # The JAX package compares with kp_extent**2 rounded once to fp32.
    in_range = (sq_distances < float(np.float32(kp_extent**2))).any(2)  # [Nq,H]
    if recording():  # a pad query's shadows lie at its own PAD_COORD: in range
        real = neighb_inds < s_pts.shape[0]
        record("deform.real_neighbors", level, real)
        record("deform.kept_neighbors", level, in_range & real)
        record("deform.cap_rows", level, neighb_inds.numel())
    all_weights = influence_fn(sq_distances, kp_extent, influence)
    if aggregation == "closest":
        all_weights = all_weights * nn.functional.one_hot(
            sq_distances.argmin(-1), kernel_points.shape[0]).to(all_weights.dtype)
    elif aggregation != "sum":
        raise ValueError(f"Unknown aggregation mode: {aggregation}")
    all_weights = all_weights * in_range[:, :, None].to(all_weights.dtype)
    # An index_select whose backward is an index_add_: the indexing
    # backward of x[idx] serializes the shadows' duplicates of one row.
    neighb_x = pad_gather_rows(x, neighb_inds)  # [Nq,H,C], shadows zero
    weighted = torch.einsum("nhk,nhc->nkc", all_weights, neighb_x)
    if modulations is not None:
        weighted = weighted * modulations[:, :, None]
    out = weighted.reshape(weighted.shape[0], -1) @ weights.reshape(-1, weights.shape[-1])
    # The count over the pruned set: pruned rows gather zero features.
    feat_sum = neighb_x.sum(-1) * in_range.to(neighb_x.dtype)
    neighbor_num = (feat_sum > 0.0).sum(-1).clamp_min(1)
    return out / neighbor_num[:, None].to(out.dtype)


def _stack_tiled(tile_meta, nq: int, ns: int, tile: int):
    """Stack B clouds into one candidate-tile problem: per-cloud supports
    padded to whole tiles, tile ids offset by the cloud's tile base, and
    queries padded to whole 128-query groups."""
    lidx, tiles = tile_meta  # [B, G·128, H], [B, G, M]
    b, g_count, m_tiles = tiles.shape
    ns_pad = -(-ns // tile) * tile
    boff = (torch.arange(b, device=tiles.device, dtype=tiles.dtype) * (ns_pad // tile))
    tiles_st = (tiles + boff[:, None, None]).reshape(b * g_count, m_tiles).contiguous()
    lidx_st = lidx.reshape(b * g_count * 128, -1).contiguous()
    return lidx_st, tiles_st, ns_pad, g_count * 128


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, N, C] -> [B, n, C] with zero rows appended."""
    if x.shape[1] == n:
        return x
    return torch.cat([x, x.new_zeros(x.shape[0], n - x.shape[1], x.shape[2])], 1)


def stack_inds(neighb_inds: torch.Tensor, ns: int) -> torch.Tensor:
    """[B, Nq, H] per-cloud neighbor indices (pad = Ns) -> [B·Nq, H] into the
    B stacked clouds, every shadow mapped past the stack (B·Ns)."""
    b = neighb_inds.shape[0]
    off = (torch.arange(b, device=neighb_inds.device, dtype=neighb_inds.dtype) * ns)
    stacked = torch.where(neighb_inds >= ns, b * ns, neighb_inds + off[:, None, None])
    return stacked.reshape(-1, neighb_inds.shape[2])


class KPConv(nn.Module):
    """KPConv over a leading cloud axis.  Parameters use the reference torch
    key layout: ``weights`` [K, C, D] and the ``kernel_points`` buffer
    [K, 3] (each layer's own rotated/jittered disposition); deformable,
    also ``offset_conv`` (a rigid KPConv with its own disposition, seed +
    7919, out width 3K, or 4K when modulated) and the zero-initialized
    ``offset_bias`` (reference blocks.py:179-199).  ``level`` is the
    query level (``KPFCNN`` sets it), which indexes the ``deform.*``
    counters.  ``impl`` and ``tiled`` are the config's ``kpconv_impl`` and
    ``kpconv_tiled``.

    The routes (``conv_route`` picks one a call; both clouds go in one):

    * ``tiled``: K2 on the candidate tiles (``ops/kpconv_tiled.py::
      kpconv_tiled_ad``), backward K3 with K4 folded in; strided shortcut
      ``max_pool_first`` (K5).  ``fused`` and ``kpconv_tiled`` on a pyramid
      with tile metadata: the default.
    * ``gathered``: K6 (``ops/kpconv_fused.py::kpconv_fused_ad``) over the
      gathered features and the level's shared rel, backward K3's gathered
      entry: ``fused`` otherwise.
    * ``merged``: the strided ``gathered``, K7 over ONE merged gather
      [coords | 0 pad | conv features | shortcut features]; the shortcut
      is the max over the same rows.
    * ``reduce``: K8 (``ops/kpconv_pallas.py``) and a matmul with W, where
      C >= 8 under sum aggregation; serves only.  Shortcut ``max_pool``.
    * ``dense``: the plain formulation, for ``xla`` and ``reduce``'s other
      convs.  Shortcut ``max_pool``.
    * ``deformable``: ``kpconv_deformable`` after the rigid offset sub-conv
      on its own route without tile metadata (``gathered`` on ``fused``);
      shortcut ``max_pool_first`` on a tile pyramid, else ``max_pool``."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 kp_extent: float, num_kernel_points: int = 15,
                 influence: str = "linear", aggregation: str = "sum",
                 fixed: str = "center", seed: int = 0, ones_features: bool = False,
                 tile: int = 128, impl: str = "fused", tiled: bool = True,
                 deformable: bool = False, modulated: bool = False):
        super().__init__()
        conv_route(impl)  # an unknown impl fails here
        self.kp_extent = kp_extent
        self.influence = influence
        self.aggregation = aggregation
        self.ones_features = ones_features
        self.tile = tile
        self.impl = impl
        self.tiled = tiled
        self.deformable = deformable
        self.modulated = modulated
        self.level = 0
        kp = layer_kernel_points(radius, num_kernel_points, fixed=fixed, seed=seed)
        self.register_buffer("kernel_points", torch.from_numpy(kp))
        self.weights = nn.Parameter(torch.empty(num_kernel_points, in_channels, out_channels))
        if deformable:
            offset_dim = (4 if modulated else 3) * num_kernel_points
            self.offset_conv = KPConv(
                in_channels, offset_dim, radius, kp_extent, num_kernel_points, influence,
                aggregation, fixed, seed + 7919, ones_features, tile, impl, tiled)
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch kaiming_uniform_(a=√5) on [K, C, D]: bound = √(1/(C·D))."""
        bound = (1.0 / (self.weights.shape[1] * self.weights.shape[2])) ** 0.5
        with torch.no_grad():
            self.weights.uniform_(-bound, bound, generator=generator)

    def route(self, strided: bool, tiled_pyramid: bool) -> ConvRoute:
        """This conv's route, strided or not, on a pyramid with tile metadata or not."""
        return conv_route(self.impl, self.tiled, self.aggregation, strided=strided,
                          deformable=self.deformable, in_channels=self.weights.shape[1],
                          tiled_pyramid=tiled_pyramid)

    def forward(self, q_pts, s_pts, neighb_inds, x, neighbors_rel=None, shortcut_x=None,
                tile_meta=None):
        """q_pts [B,Nq,3], s_pts [B,Ns,3], neighb_inds [B,Nq,H] (pad = Ns),
        x [B,Ns,C] -> [B,Nq,D].  ``neighbors_rel`` [B,Nq,H,3]: the level's
        shared rel, or None.  ``tile_meta`` = (lidx [B,G·128,H], tiles
        [B,G,M]): the tiled search's metadata of these lists, or None.  A
        strided conv (``shortcut_x`` [B,Ns,C2]) returns (out, its
        max-pooled shortcut [B,Nq,C2]); blocks call ``strided``."""
        b, nq = q_pts.shape[:2]
        ns = s_pts.shape[1]
        route = self.route(shortcut_x is not None, tile_meta is not None)
        if route.conv == "tiled":
            out = self._tiled(q_pts, s_pts, x, tile_meta)
        elif route.conv == "deformable":
            out = self._deformable(q_pts, s_pts, neighb_inds, x, neighbors_rel)
        else:  # the shortcut, if any, comes from the conv's own call
            inds = stack_inds(neighb_inds, ns)
            rel = None if neighbors_rel is None else neighbors_rel.reshape(b * nq, -1, 3)
            sx = None if shortcut_x is None else shortcut_x.reshape(b * ns, -1)
            out = kpconv(
                q_pts.reshape(b * nq, 3), s_pts.reshape(b * ns, 3), inds,
                x.reshape(b * ns, -1), self.kernel_points, self.weights,
                float(self.kp_extent), self.influence, self.aggregation, neighbors_rel=rel,
                ones_features=self.ones_features, impl=self.impl, shortcut_x=sx,
            )
            if shortcut_x is None:
                return out.reshape(b, nq, -1)
            return tuple(t.reshape(b, nq, -1) for t in out)
        if shortcut_x is None:
            return out
        if route.shortcut == "max_pool_first":
            return out, max_pool_first(shortcut_x, neighb_inds)
        return out, max_pool(shortcut_x.reshape(b * ns, -1),
                             stack_inds(neighb_inds, ns)).reshape(b, nq, -1)

    def strided(self, q_pts, s_pts, neighb_inds, x, shortcut_x, neighbors_rel=None,
                tile_meta=None):
        """``forward(..., shortcut_x=)``, but a ``max_pool_first`` shortcut
        runs after the module's call, so forward hooks around it
        (``perfbench/core/trace.py::KPConvHooks``) time the conv alone; the
        ``merged`` and ``max_pool`` rules take theirs inside the call."""
        if self.route(True, tile_meta is not None).shortcut != "max_pool_first":
            return self(q_pts, s_pts, neighb_inds, x, neighbors_rel, shortcut_x, tile_meta)
        return (self(q_pts, s_pts, neighb_inds, x, neighbors_rel, tile_meta=tile_meta),
                max_pool_first(shortcut_x, neighb_inds))

    def _deformable(self, q_pts, s_pts, neighb_inds, x, neighbors_rel):
        """Offsets (and modulations) from the rigid sub-conv, then
        ``kpconv_deformable`` over both clouds stacked (reference
        blocks.py:235-260: offsets scaled by KP_extent, modulations
        2·sigmoid)."""
        b, nq = q_pts.shape[:2]
        ns = s_pts.shape[1]
        k = self.kernel_points.shape[0]
        with span("deform.offset"):
            feats = (self.offset_conv(q_pts, s_pts, neighb_inds, x, neighbors_rel)
                     + self.offset_bias)
        feats = feats.reshape(b * nq, -1)
        offsets = feats[:, :3 * k].reshape(b * nq, k, 3) * self.kp_extent
        modulations = 2.0 * torch.sigmoid(feats[:, 3 * k:]) if self.modulated else None
        with span("deform.conv"):
            out = kpconv_deformable(
                q_pts.reshape(b * nq, 3), s_pts.reshape(b * ns, 3), stack_inds(neighb_inds, ns),
                x.reshape(b * ns, -1), self.kernel_points, self.weights, float(self.kp_extent),
                offsets, modulations, self.influence, self.aggregation, self.level,
            )
        return out.reshape(b, nq, -1)

    def _tiled(self, q_pts, s_pts, x, tile_meta):
        b, nq = q_pts.shape[:2]
        ns = s_pts.shape[1]
        lidx, tiles, ns_pad, nq_pad = _stack_tiled(tile_meta, nq, ns, self.tile)
        if self.ones_features:
            x = torch.ones_like(s_pts[..., :1])
        out, nn_count = kpconv_tiled_ad(
            _pad_to(q_pts, nq_pad).reshape(b * nq_pad, 3).contiguous(),
            _pad_to(s_pts, ns_pad).reshape(b * ns_pad, 3).contiguous(),
            _pad_to(x.float(), ns_pad).reshape(b * ns_pad, -1).contiguous(),
            lidx, tiles, self.kernel_points, self.weights.contiguous(),
            float(self.kp_extent), self.influence, self.aggregation, tile=self.tile,
        )
        out = out / nn_count[:, None]
        return out.reshape(b, nq_pad, -1)[:, :nq]
