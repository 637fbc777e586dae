"""Plain deformable KPConv for the reference (KPConv, Thomas et al., ICCV
2019, arXiv:1904.08889; its repository's models/blocks.py:235-316, which
PCR-CG's repository inherits), and the reference model of a configuration
whose ``architecture`` lists ``*_deformable`` blocks.

A deformable KPConv reads the neighborhood of a rigid one.  A rigid
sub-conv over it (``offset_conv``: its own disposition, seed + 7919, width
3K, or 4K when modulated) plus ``offset_bias`` predicts K offsets a query,
scaled by KP_extent; query n's kernel points move to ``kernel_points +
offsets[n]``.  Neighbors farther than KP_extent from every deformed point
are pruned and leave the neighbor count (with static shapes: their
influences are zero and their features drop out of the count).  The
modulations, when present, are 2·sigmoid of the last K outputs and scale
each kernel point's weighted features.

``build_model`` builds ``models/pcrcg.py::PCRCG`` over the rigid
version of the architecture (``models/kpconv.py`` holds rigid KPConv
only) and puts a ``DeformableKPConv`` in place of each deformable block's
conv, under the same parameter names as the port's.  The pyramid's widened
searches come from the configuration itself (``ops/pyramid.py::
build_pyramid_cfg``), which the pipeline hands the configuration as it is.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from perfbench.reference.geom.kernel_points import layer_kernel_points
from perfbench.reference.models.kpconv import KPConv, stack_inds
from perfbench.reference.models.pcrcg import PCRCG
from perfbench.reference.ops.kpconv_common import influence_fn
from perfbench.reference.ops.masked import PAD_COORD, pad_gather


def kpconv_deformable(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent: float,
                      offsets, modulations=None, influence: str = "linear",
                      aggregation: str = "sum"):
    """q_pts [Nq,3], s_pts [Ns,3], neighb_inds [Nq,H] (pad = Ns), x [Ns,C],
    kernel_points [K,3], weights [K,C,D], offsets [Nq,K,3] (scaled),
    modulations [Nq,K] or None -> [Nq,D]."""
    neighbors = pad_gather(s_pts, neighb_inds, fill_value=PAD_COORD) - q_pts[:, None, :]
    deformed = kernel_points[None, :, :] + offsets
    sq_distances = ((neighbors[:, :, None, :] - deformed[:, None, :, :]) ** 2).sum(-1)
    kept = (sq_distances < float(np.float32(kp_extent**2))).any(2)  # [Nq,H]
    all_weights = influence_fn(sq_distances, kp_extent, influence)
    if aggregation == "closest":
        all_weights = all_weights * nn.functional.one_hot(
            sq_distances.argmin(-1), kernel_points.shape[0]).to(all_weights.dtype)
    elif aggregation != "sum":
        raise ValueError(f"Unknown aggregation mode: {aggregation}")
    all_weights = all_weights * kept[:, :, None].to(all_weights.dtype)
    neighb_x = pad_gather(x, neighb_inds, fill_value=0.0)  # [Nq,H,C]
    weighted = torch.einsum("nhk,nhc->nkc", all_weights, neighb_x)
    if modulations is not None:
        weighted = weighted * modulations[:, :, None]
    out = weighted.reshape(weighted.shape[0], -1) @ weights.reshape(-1, weights.shape[-1])
    feat_sum = neighb_x.sum(-1) * kept.to(neighb_x.dtype)
    neighbor_num = (feat_sum > 0.0).sum(-1).clamp_min(1)
    return out / neighbor_num[:, None].to(out.dtype)


class DeformableKPConv(nn.Module):
    """Deformable KPConv over a leading cloud axis: ``weights`` [K, C, D],
    the ``kernel_points`` buffer, ``offset_conv`` (a rigid ``KPConv``) and
    ``offset_bias``, named as the port's."""

    def __init__(self, in_channels: int, out_channels: int, radius: float, kp_extent: float,
                 num_kernel_points: int = 15, influence: str = "linear",
                 aggregation: str = "sum", fixed: str = "center", seed: int = 0,
                 modulated: bool = False):
        super().__init__()
        self.kp_extent = kp_extent
        self.influence = influence
        self.aggregation = aggregation
        self.modulated = modulated
        kp = layer_kernel_points(radius, num_kernel_points, fixed=fixed, seed=seed)
        self.register_buffer("kernel_points", torch.from_numpy(kp))
        self.weights = nn.Parameter(torch.empty(num_kernel_points, in_channels, out_channels))
        offset_dim = (4 if modulated else 3) * num_kernel_points
        self.offset_conv = KPConv(in_channels, offset_dim, radius, kp_extent, num_kernel_points,
                                  influence, aggregation, fixed, seed + 7919)
        self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def forward(self, q_pts, s_pts, neighb_inds, x, neighbors_rel=None, tiled_meta=None):
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
            offsets, modulations, self.influence, self.aggregation)
        return out.reshape(b, nq, -1)


def build_model(cfg, state: Mapping[str, torch.Tensor], device) -> PCRCG:
    """As ``pipeline.build_model``, for any architecture: the reference
    model on ``device`` with ``state`` (keyed as the port's ``PCRCG``
    state dict); the kernel points are the reference's own."""
    rigid = cfg.replace(architecture_list=tuple(b.replace("_deformable", "")
                                                for b in cfg.architecture), modulated=False)
    model = PCRCG(rigid)
    extent_ratio = cfg.KP_extent / cfg.conv_radius
    for block, plan, name in zip(model.kpfcnn.encoder_blocks, model.kpfcnn.plan.encoder,
                                 cfg.architecture):
        if "deformable" in name:
            c_in, c_out = block.KPConv.weights.shape[1:]
            block.KPConv = DeformableKPConv(
                c_in, c_out, plan.radius, plan.radius * extent_ratio, cfg.num_kernel_points,
                cfg.KP_influence, cfg.aggregation_mode, cfg.fixed_kernel_points, plan.kp_seed,
                cfg.modulated)
    model = model.to(device)
    own = model.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("kernel_points")]
    if missing:
        raise KeyError(f"weights missing for {missing[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            if not name.endswith("kernel_points"):
                t.copy_(state[name])
    return model.eval()
