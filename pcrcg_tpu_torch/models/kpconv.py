"""Kernel-point convolution (counterpart of ``pcrcg_tpu/models/kpconv.py``).

``kpconv`` is one conv over one point set, on the route ``impl`` selects,
as the JAX package's ``kpconv`` (reference models/blocks.py:284-372):

* ``xla`` — the plain dense formulation: gather neighbor coordinates
  (shadow -> PAD_COORD, so zero influence) and features (shadow -> 0),
  influence against the K kernel points, weighted reduce over neighbors,
  one [K·C] x [K·C, D] contraction, division by the reference's
  positive-feature-sum neighbor count.  The reference the kernels are
  tested against.
* ``fused`` — K6 (``ops/kpconv_fused.py::kpconv_fused_ad``) over the
  gathered features [H, C, N] and the level's shared rel; with
  ``shortcut_x`` (the strided blocks) K7 over ONE merged gather of
  [coords | 0 pad | conv features | shortcut features], whose shortcut is
  the max over the same gathered rows.
* ``reduce`` — K8 (``ops/kpconv_pallas.py::kpconv_weighted_reduce``) and a
  ``torch.matmul`` with W, where C ≥ 8 under sum aggregation; otherwise the
  dense formulation.  Serves only: K8 has no backward.

The ``KPConv`` module stacks both clouds into one call per conv.  With the
tiled search's metadata (the default ``kpconv_tiled`` route) it runs the
candidate-tile kernel, ``ops/kpconv_tiled.py::kpconv_tiled_ad`` (K2
forward, K3 + K4 backward).  The gathers of the untiled routes are
``index_select``s whose backward is an ``index_add_``.

Deformable (and modulated) KPConv (reference blocks.py:235-372):
``kpconv_deformable`` is the dense formulation against per-query kernel
points, plain PyTorch as in the JAX package (pcrcg_tpu/models/kpconv.py:
253-334, which has no Pallas kernel for it).  Its rigid ``offset_conv``
sub-module predicts the offsets (and modulations) on the module's route
without the tiled metadata: K6 forward and K3's gathered entry backward on
the card for ``fused``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pcrcg_tpu_torch.geom.kernel_points import layer_kernel_points
from pcrcg_tpu_torch.ops import kpconv_fused, kpconv_pallas
from pcrcg_tpu_torch.ops.kpconv_common import influence_fn
from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled_ad
from pcrcg_tpu_torch.ops.masked import PAD_COORD, pad_gather, pad_gather_rows

IMPLS = ("fused", "reduce", "xla")


def resolve_kpconv_impl(impl: str) -> str:
    """``auto`` -> ``fused`` on every device: on the CPU the port runs each
    kernel's plain version.  (The JAX package resolves ``auto`` to ``xla``
    off the TPU.)"""
    impl = "fused" if impl == "auto" else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown kpconv_impl {impl!r}: one of auto, {', '.join(IMPLS)}")
    return impl


def max_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """x [Ns, C], inds [Nq, H] (pad >= Ns) -> [Nq, C]: the max over the
    neighbors, a shadow contributing a zero row (reference blocks.py:86-103).
    Its gradient splits evenly among tied maxima (``amax``, as ``jnp.max``'s
    VJP): the rule of the JAX package's untiled routes
    (pcrcg_tpu/models/blocks.py:45-50)."""
    return pad_gather_rows(x, inds).amax(1)


def _dense(neighbors, neighb_x, kernel_points, weights, kp_extent, influence, aggregation):
    """The dense formulation on gathered rel [Nq, H, 3] and features
    [Nq, H, C] -> [Nq, D]."""
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
    kernel_points [K,3], weights [K,C,D] -> [Nq,D].

    ``neighbors_rel`` [Nq,H,3] (gathered neighbor coordinates minus query)
    may be computed once per pyramid level and shared by its convs.  With
    ``shortcut_x`` [Ns, C2] it also returns, second, the strided block's
    max-pooled shortcut ``max_h shortcut_x[neighbor]`` (zero shadow rows):
    on ``fused`` from the conv's own merged gather, else ``max_pool``."""
    if impl == "fused" and shortcut_x is not None:
        return _merged(q_pts, s_pts, neighb_inds, x, shortcut_x, kernel_points, weights,
                       kp_extent, influence, aggregation, ones_features)
    if neighbors_rel is None:
        neighbors_rel = pad_gather(s_pts, neighb_inds, fill_value=PAD_COORD) - q_pts[:, None, :]
    if ones_features:
        # Ones-column input: the gathered feature is "neighbor index is real".
        nx = (neighb_inds < x.shape[0]).to(x.dtype)[..., None]
    else:
        nx = None

    if impl == "fused":
        nx = pad_gather_rows(x, neighb_inds) if nx is None else nx
        out, neighbor_num = kpconv_fused.kpconv_fused_ad(
            neighbors_rel.contiguous(), nx.permute(1, 2, 0).contiguous(), kernel_points,
            weights, kp_extent, influence, aggregation, needs_dnx=not ones_features,
        )
        out = out / neighbor_num[:, None]
    elif impl == "reduce" and aggregation == "sum" and x.shape[-1] >= 8:
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
                      aggregation: str = "sum"):
    """Deformable KPConv over one point set: as ``kpconv``, with the kernel
    points of query n at ``kernel_points + offsets[n]`` (offsets [Nq, K, 3],
    already scaled by KP_extent) and the weighted features of kernel point k
    multiplied by ``modulations[n, k]`` when given ([Nq, K]).

    The reference prunes, per query, the neighbors farther than KP_extent
    from every deformed kernel point and re-pads them as shadows
    (blocks.py:292-316); with static shapes their influences are zeroed and
    they leave the neighbor count, which gives the same output for every
    influence and aggregation."""
    neighbors = pad_gather(s_pts, neighb_inds, fill_value=PAD_COORD) - q_pts[:, None, :]
    deformed = kernel_points[None, :, :] + offsets  # [Nq,K,3]
    diff = neighbors[:, :, None, :] - deformed[:, None, :, :]
    sq_distances = (diff * diff).sum(-1)  # [Nq,H,K]
    # The JAX package compares with kp_extent**2 rounded once to fp32.
    in_range = (sq_distances < float(np.float32(kp_extent**2))).any(2)  # [Nq,H]
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


def _stack_tiled(tiled_meta, nq: int, ns: int, tile: int):
    """Stack B clouds into one candidate-tile problem: per-cloud supports
    padded to whole tiles, tile ids offset by the cloud's tile base, and
    queries padded to whole 128-query groups."""
    lidx, tiles = tiled_meta  # [B, G·128, H], [B, G, M]
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
    ``offset_bias`` (reference blocks.py:179-199)."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 kp_extent: float, num_kernel_points: int = 15,
                 influence: str = "linear", aggregation: str = "sum",
                 fixed: str = "center", seed: int = 0, ones_features: bool = False,
                 tile: int = 128, impl: str = "fused", deformable: bool = False,
                 modulated: bool = False):
        super().__init__()
        self.kp_extent = kp_extent
        self.influence = influence
        self.aggregation = aggregation
        self.ones_features = ones_features
        self.tile = tile
        self.impl = resolve_kpconv_impl(impl)
        self.deformable = deformable
        self.modulated = modulated
        kp = layer_kernel_points(radius, num_kernel_points, fixed=fixed, seed=seed)
        self.register_buffer("kernel_points", torch.from_numpy(kp))
        self.weights = nn.Parameter(torch.empty(num_kernel_points, in_channels, out_channels))
        if deformable:
            offset_dim = (4 if modulated else 3) * num_kernel_points
            self.offset_conv = KPConv(
                in_channels, offset_dim, radius, kp_extent, num_kernel_points, influence,
                aggregation, fixed, seed + 7919, ones_features, tile, impl)
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch kaiming_uniform_(a=√5) on [K, C, D]: bound = √(1/(C·D))."""
        bound = (1.0 / (self.weights.shape[1] * self.weights.shape[2])) ** 0.5
        with torch.no_grad():
            self.weights.uniform_(-bound, bound, generator=generator)

    def forward(self, q_pts, s_pts, neighb_inds, x, neighbors_rel=None, shortcut_x=None,
                tiled_meta=None):
        """q_pts [B,Nq,3], s_pts [B,Ns,3], neighb_inds [B,Nq,H] (pad = Ns),
        x [B,Ns,C] -> [B,Nq,D].  ``neighbors_rel`` [B,Nq,H,3]: the level's
        shared rel.  ``shortcut_x`` [B,Ns,C2] also returns the max-pooled
        shortcut [B,Nq,C2] (``fused``: from the conv's own gather; otherwise
        ``max_pool``).  ``tiled_meta`` = (lidx [B,G·128,H], tiles [B,G,M])
        from the tiled search selects the candidate-tile kernel on the
        ``fused`` route."""
        b, nq = q_pts.shape[:2]
        ns = s_pts.shape[1]
        if self.deformable:
            out = self._deformable(q_pts, s_pts, neighb_inds, x, neighbors_rel)
            if shortcut_x is None:
                return out
            return out, max_pool(shortcut_x.reshape(b * ns, -1),
                                 stack_inds(neighb_inds, ns)).reshape(b, nq, -1)
        if tiled_meta is not None and shortcut_x is None and self.impl == "fused":
            return self._tiled(q_pts, s_pts, x, tiled_meta)
        inds = stack_inds(neighb_inds, ns)
        rel = None if neighbors_rel is None else neighbors_rel.reshape(b * nq, -1, 3)
        sx = None if shortcut_x is None else shortcut_x.reshape(b * ns, -1)
        out = kpconv(
            q_pts.reshape(b * nq, 3), s_pts.reshape(b * ns, 3), inds, x.reshape(b * ns, -1),
            self.kernel_points, self.weights, float(self.kp_extent), self.influence,
            self.aggregation, neighbors_rel=rel, ones_features=self.ones_features,
            impl=self.impl, shortcut_x=sx,
        )
        if shortcut_x is None:
            return out.reshape(b, nq, -1)
        out, shortcut = out
        return out.reshape(b, nq, -1), shortcut.reshape(b, nq, -1)

    def _deformable(self, q_pts, s_pts, neighb_inds, x, neighbors_rel):
        """Offsets (and modulations) from the rigid sub-conv, then
        ``kpconv_deformable`` over both clouds stacked (reference
        blocks.py:235-260: offsets scaled by KP_extent, modulations
        2·sigmoid); the tiled metadata is not used."""
        b, nq = q_pts.shape[:2]
        ns = s_pts.shape[1]
        k = self.kernel_points.shape[0]
        feats = self.offset_conv(q_pts, s_pts, neighb_inds, x, neighbors_rel) + self.offset_bias
        feats = feats.reshape(b * nq, -1)
        offsets = feats[:, :3 * k].reshape(b * nq, k, 3) * self.kp_extent
        modulations = 2.0 * torch.sigmoid(feats[:, 3 * k:]) if self.modulated else None
        out = kpconv_deformable(
            q_pts.reshape(b * nq, 3), s_pts.reshape(b * ns, 3), stack_inds(neighb_inds, ns),
            x.reshape(b * ns, -1), self.kernel_points, self.weights, float(self.kp_extent),
            offsets, modulations, self.influence, self.aggregation,
        )
        return out.reshape(b, nq, -1)

    def _tiled(self, q_pts, s_pts, x, tiled_meta):
        b, nq = q_pts.shape[:2]
        ns = s_pts.shape[1]
        lidx, tiles, ns_pad, nq_pad = _stack_tiled(tiled_meta, nq, ns, self.tile)
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
