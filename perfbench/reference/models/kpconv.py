"""Frozen plain copy of the port's ``models/kpconv.py``: the dense
formulation of every rigid KPConv (the port's ``xla`` route): gather the
neighbor coordinates (shadow -> PAD_COORD, so zero influence) and features
(shadow -> 0), influence against the K kernel points, weighted reduce over
the neighbors, one [K·C] x [K·C, D] contraction, division by the
positive-feature-sum neighbor count.  The port's candidate-tile kernels
(K2 forward, K3 + K4 backward) compute the same function over the same
neighbor lists; their tile-local metadata is ignored here.
"""
from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.geom.kernel_points import layer_kernel_points
from perfbench.reference.ops.kpconv_common import influence_fn
from perfbench.reference.ops.masked import PAD_COORD, pad_gather


def resolve_kpconv_impl(impl: str) -> str:
    """Every route is the dense formulation here."""
    return "xla"

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


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent: float,
           influence: str = "linear", aggregation: str = "sum", neighbors_rel=None,
           ones_features: bool = False):
    """q_pts [Nq,3], s_pts [Ns,3], neighb_inds [Nq,H] (pad = Ns), x [Ns,C],
    kernel_points [K,3], weights [K,C,D] -> [Nq,D]."""
    if neighbors_rel is None:
        neighbors_rel = pad_gather(s_pts, neighb_inds, fill_value=PAD_COORD) - q_pts[:, None, :]
    if ones_features:
        # Ones-column input: the gathered feature is "neighbor index is real".
        nx = (neighb_inds < x.shape[0]).to(x.dtype)[..., None]
    else:
        nx = pad_gather(x, neighb_inds, fill_value=0.0)  # [Nq,H,C]
    return _dense(neighbors_rel, nx, kernel_points, weights, kp_extent, influence, aggregation)


def stack_inds(neighb_inds: torch.Tensor, ns: int) -> torch.Tensor:
    """[B, Nq, H] per-cloud neighbor indices (pad = Ns) -> [B·Nq, H] into the
    B stacked clouds, every shadow mapped past the stack (B·Ns)."""
    b = neighb_inds.shape[0]
    off = (torch.arange(b, device=neighb_inds.device, dtype=neighb_inds.dtype) * ns)
    stacked = torch.where(neighb_inds >= ns, b * ns, neighb_inds + off[:, None, None])
    return stacked.reshape(-1, neighb_inds.shape[2])


class KPConv(nn.Module):
    """KPConv over a leading cloud axis: ``weights`` [K, C, D] and the
    ``kernel_points`` buffer [K, 3] (each layer's own rotated / jittered
    disposition), the port's key layout."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 kp_extent: float, num_kernel_points: int = 15,
                 influence: str = "linear", aggregation: str = "sum",
                 fixed: str = "center", seed: int = 0, ones_features: bool = False,
                 tile: int = 128, impl: str = "xla", deformable: bool = False,
                 modulated: bool = False):
        super().__init__()
        if deformable:
            raise NotImplementedError("the reference holds rigid KPConv only")
        self.kp_extent = kp_extent
        self.influence = influence
        self.aggregation = aggregation
        self.ones_features = ones_features
        kp = layer_kernel_points(radius, num_kernel_points, fixed=fixed, seed=seed)
        self.register_buffer("kernel_points", torch.from_numpy(kp))
        self.weights = nn.Parameter(torch.empty(num_kernel_points, in_channels, out_channels))

    def forward(self, q_pts, s_pts, neighb_inds, x, neighbors_rel=None, tiled_meta=None):
        """q_pts [B,Nq,3], s_pts [B,Ns,3], neighb_inds [B,Nq,H] (pad = Ns),
        x [B,Ns,C] -> [B,Nq,D]; ``neighbors_rel`` [B,Nq,H,3]: the level's
        shared rel."""
        b, nq = q_pts.shape[:2]
        ns = s_pts.shape[1]
        rel = None if neighbors_rel is None else neighbors_rel.reshape(b * nq, -1, 3)
        out = kpconv(
            q_pts.reshape(b * nq, 3), s_pts.reshape(b * ns, 3), stack_inds(neighb_inds, ns),
            x.reshape(b * ns, -1), self.kernel_points, self.weights, float(self.kp_extent),
            self.influence, self.aggregation, neighbors_rel=rel,
            ones_features=self.ones_features,
        )
        return out.reshape(b, nq, -1)
