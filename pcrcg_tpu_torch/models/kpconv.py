"""Kernel-point convolution (counterpart of ``pcrcg_tpu/models/kpconv.py``).

``kpconv`` is the plain dense formulation (the JAX package's ``xla`` path,
with its ones-column fast path): gather neighbor coordinates (shadow ->
PAD_COORD, so zero influence) and features (shadow -> 0), influence against
the K kernel points, weighted reduce over neighbors, one [K·C] x [K·C, D]
contraction, division by the reference's positive-feature-sum neighbor
count (reference models/blocks.py:284-372).  It is the reference the
candidate-tile kernel is tested against.

The ``KPConv`` module runs the candidate-tile route with the tile-local
metadata of the tiled search, both clouds in one launch:
``ops/kpconv_tiled.py::kpconv_tiled_ad``, K2 forward and, when a gradient
is taken, K3 + K4 backward.
"""
from __future__ import annotations

import torch
from torch import nn

from pcrcg_tpu_torch.geom.kernel_points import layer_kernel_points
from pcrcg_tpu_torch.ops.kpconv_common import influence_fn
from pcrcg_tpu_torch.ops.kpconv_tiled import kpconv_tiled_ad
from pcrcg_tpu_torch.ops.masked import PAD_COORD, pad_gather


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent: float,
           influence: str = "linear", aggregation: str = "sum",
           ones_features: bool = False):
    """q_pts [Nq,3], s_pts [Ns,3], neighb_inds [Nq,H] (pad = Ns), x [Ns,C],
    kernel_points [K,3], weights [K,C,D] -> [Nq,D]."""
    neighbors = pad_gather(s_pts, neighb_inds, fill_value=PAD_COORD) - q_pts[:, None, :]
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
    if ones_features:
        # Ones-column input: the gathered feature is "neighbor index is real".
        neighb_x = (neighb_inds < x.shape[0]).to(x.dtype)[..., None]
    else:
        neighb_x = pad_gather(x, neighb_inds, fill_value=0.0)  # [Nq,H,C]
    weighted = torch.einsum("nhk,nhc->nkc", all_weights, neighb_x)
    out = weighted.reshape(weighted.shape[0], -1) @ weights.reshape(-1, weights.shape[-1])
    neighbor_num = (neighb_x.sum(-1) > 0.0).sum(-1).clamp_min(1)
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


class KPConv(nn.Module):
    """Rigid KPConv over a leading cloud axis.  Parameters use the reference
    torch key layout: ``weights`` [K, C, D] and the ``kernel_points``
    buffer [K, 3] (each layer's own rotated/jittered disposition)."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 kp_extent: float, num_kernel_points: int = 15,
                 influence: str = "linear", aggregation: str = "sum",
                 fixed: str = "center", seed: int = 0, ones_features: bool = False,
                 tile: int = 128):
        super().__init__()
        self.kp_extent = kp_extent
        self.influence = influence
        self.aggregation = aggregation
        self.ones_features = ones_features
        self.tile = tile
        kp = layer_kernel_points(radius, num_kernel_points, fixed=fixed, seed=seed)
        self.register_buffer("kernel_points", torch.from_numpy(kp))
        self.weights = nn.Parameter(torch.empty(num_kernel_points, in_channels, out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch kaiming_uniform_(a=√5) on [K, C, D]: bound = √(1/(C·D))."""
        bound = (1.0 / (self.weights.shape[1] * self.weights.shape[2])) ** 0.5
        with torch.no_grad():
            self.weights.uniform_(-bound, bound, generator=generator)

    def forward(self, q_pts, s_pts, x, tiled_meta):
        """q_pts [B,Nq,3], s_pts [B,Ns,3], x [B,Ns,C], tiled_meta = (lidx
        [B,G·128,H], tiles [B,G,M]) from the tiled search -> [B,Nq,D]."""
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
