"""Frozen plain copy of the port's ``models/gcn.py`` for the benchmark's
reference (it imports nothing of the port).  The original's text follows.

Overlap-attention GNN at the bottleneck (counterpart of
``pcrcg_tpu/models/gcn.py``; reference models/gcn.py:37-218): DGCNN-style
self attention over a coordinate kNN graph and SuperGlue-style cross
attention, masked, one cloud [N, C] at a time.  1x1 convolutions keep the
reference's weight shapes ([out, in, 1] / [out, in, 1, 1]) and run as
matrix products.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.ops.masked import masked_instance_norm, masked_softmax, pad_gather
from perfbench.reference.ops.neighbors import knn_search


class Conv1x1(nn.Module):
    """A 1x1 Conv1d/Conv2d's parameters ([out, in, 1] or [out, in, 1, 1])
    applied over the last axis of a channels-last tensor."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, ndim: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_dim, in_dim) + (1,) * ndim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1), self.bias)


def graph_features(coords, feats, mask, k: int, query_chunk: int):
    """DGCNN edge features [N, k, 2C] = [x_i, x_j − x_i] over the coordinate
    kNN graph, self excluded (reference gcn.py:37-64); pad neighbors give
    zero edges.  Also returns the edge validity [N, k]."""
    n = coords.shape[0]
    idx, _ = knn_search(coords, coords, mask, k + 1, query_chunk)
    idx = idx[:, 1:]  # drop self (nearest)
    nbr = pad_gather(feats, idx, 0.0)  # [N, k, C]
    valid = (idx < n)[..., None]
    center = feats[:, None, :].expand_as(nbr)
    edge = torch.cat([center, nbr - center], dim=-1)
    return torch.where(valid, edge, 0.0), valid[..., 0]


class SelfAttention(nn.Module):
    """Two edge-conv rounds + fuse (reference gcn.py:96-134)."""

    def __init__(self, dim: int, k: int = 10, query_chunk: int = 1024):
        super().__init__()
        self.k = k
        self.query_chunk = query_chunk
        self.conv1 = Conv1x1(2 * dim, dim, bias=False, ndim=2)
        self.conv2 = Conv1x1(2 * dim, 2 * dim, bias=False, ndim=2)
        self.conv3 = Conv1x1(4 * dim, dim, bias=False, ndim=2)

    def _edge_round(self, conv, coords, x, mask):
        e, e_mask = graph_features(coords, x, mask, self.k, self.query_chunk)
        e = masked_instance_norm(conv(e), e_mask & mask[:, None], dim=(0, 1))
        return F.leaky_relu(e, 0.2).amax(1)

    def forward(self, coords, feats, mask):
        x1 = self._edge_round(self.conv1, coords, feats, mask)
        x2 = self._edge_round(self.conv2, coords, x1, mask)
        x3 = self.conv3(torch.cat([feats, x1, x2], dim=-1))
        return F.leaky_relu(masked_instance_norm(x3, mask, dim=(0,)), 0.2)


class MultiHeadedAttention(nn.Module):
    """SuperGlue MHA with 1x1-conv projections (reference gcn.py:151-175).
    The head split is dim-major: head h owns channels {c : c % H == h}."""

    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.d_model = d_model
        self.proj = nn.ModuleList([Conv1x1(d_model, d_model) for _ in range(3)])
        self.merge = Conv1x1(d_model, d_model)

    def forward(self, query, key, value, key_mask):
        d = self.d_model // self.num_heads
        q, k, v = (
            proj(t).reshape(-1, d, self.num_heads)
            for proj, t in zip(self.proj, (query, key, value))
        )
        scores = torch.einsum("ndh,mdh->hnm", q, k) / (d**0.5)
        prob = masked_softmax(scores, key_mask[None, None, :], dim=-1)
        x = torch.einsum("hnm,mdh->ndh", prob, v)
        return self.merge(x.reshape(-1, self.d_model))


class AttentionalPropagation(nn.Module):
    """message = MHA(x, source); MLP [2C -> 2C -> C] with a masked instance
    norm + ReLU between (reference gcn.py:139-186).  The MLP's parameters sit
    at ``mlp.0`` and ``mlp.3``, the reference Sequential's indices."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, dim)
        self.mlp = nn.ModuleDict({"0": Conv1x1(2 * dim, 2 * dim), "3": Conv1x1(2 * dim, dim)})

    def forward(self, x, source, x_mask, source_mask):
        message = self.attn(x, source, source, source_mask)
        y = self.mlp["0"](torch.cat([x, message], dim=-1))
        y = torch.relu(masked_instance_norm(y, x_mask, dim=(0,)))
        return self.mlp["3"](y)


class GCN(nn.Module):
    """Alternating self / cross attention, residual adds for cross layers
    (reference gcn.py:188-218)."""

    def __init__(self, num_heads: int, dim: int, k: int,
                 layer_names: Sequence[str] = ("self", "cross", "self"),
                 query_chunk: int = 1024):
        super().__init__()
        self.layer_names = tuple(layer_names)
        layers = []
        for name in self.layer_names:
            if name == "self":
                layers.append(SelfAttention(dim, k, query_chunk))
            elif name == "cross":
                layers.append(AttentionalPropagation(dim, num_heads))
            else:
                raise ValueError(f"Unknown GCN layer: {name}")
        self.layers = nn.ModuleList(layers)

    def forward(self, coords0, coords1, desc0, desc1, mask0, mask1):
        for name, layer in zip(self.layer_names, self.layers):
            if name == "self":
                desc0 = layer(coords0, desc0, mask0)
                desc1 = layer(coords1, desc1, mask1)
            else:
                # desc1's message reads the UPDATED desc0 (reference gcn.py:212-213).
                desc0 = desc0 + layer(desc0, desc1, mask0, mask1)
                desc1 = desc1 + layer(desc1, desc0, mask1, mask0)
        return desc0, desc1
