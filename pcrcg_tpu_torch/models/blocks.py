"""KPFCNN network blocks (counterpart of ``pcrcg_tpu/models/blocks.py``).

Features are [B, N, C] with B the cloud axis (src/tgt) and a bool mask
[B, N].  The reference's "BatchNormBlock" is an InstanceNorm1d over the
joint src+tgt stack without affine (reference blocks.py:448,459-462); here
that is a masked per-channel normalization over both leading axes.  On
the cloud mesh axis a rank holds one cloud (B = 1) and every block takes
the axis's ``psum`` (``parallel/cloud.py``), so the norm's statistics are
still those of the joint stack.  Module and parameter names follow the
reference torch key layout.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from pcrcg_tpu_torch.models.kpconv import KPConv
from pcrcg_tpu_torch.ops.masked import masked_instance_norm, pad_gather


def init_dense(layer: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's ``make_dense`` init (torch nn.Linear's default
    U(±1/√fan_in) kernel, zero bias), drawn from ``generator``.
    ``layer.weight`` is [out, in, ...]; fan_in is its second dimension."""
    bound = (1.0 / layer.weight.shape[1]) ** 0.5
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if getattr(layer, "bias", None) is not None:
            layer.bias.zero_()


def closest_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Pool from the nearest neighbor, the first column of the distance-
    sorted list (reference blocks.py:71-83)."""
    return torch.stack([pad_gather(x[b], inds[b, :, 0], 0.0) for b in range(x.shape[0])])


def global_average(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the points: x [B, N, C], mask [B, N] -> [B, C]
    (reference blocks.py:106-125)."""
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(1) / m.sum(1).clamp_min(1.0)


class NormBlock(nn.Module):
    """InstanceNorm over the joint src+tgt stack (every shipped config has
    use_batch_norm on; the reference's learned-bias variant is not used);
    ``psum`` sums its statistics with the other cloud's rank."""

    def forward(self, x, mask, psum=None):
        return masked_instance_norm(x, mask, dim=(0, 1), psum=psum)


class UnaryBlock(nn.Module):
    """Linear (no bias) -> norm -> LeakyReLU(0.1) (reference blocks.py:473-508)."""

    def __init__(self, in_dim: int, out_dim: int, no_relu: bool = False):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)
        self.norm = NormBlock()
        self.no_relu = no_relu

    def forward(self, x, mask, psum=None):
        x = self.norm(self.mlp(x), mask, psum)
        return x if self.no_relu else F.leaky_relu(x, 0.1)


class LastUnaryBlock(nn.Module):
    """Bare linear, no norm/activation (reference blocks.py:511-533)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x, mask, psum=None):
        return self.mlp(x)


class Upsample(nn.Module):
    """Nearest upsample: copy each fine point's closest coarse feature."""

    def forward(self, x, upsample_inds):
        return closest_pool(x, upsample_inds)


class SimpleBlock(nn.Module):
    """KPConv(out/2) -> norm -> LeakyReLU(0.1) (reference blocks.py:536-590)."""

    def __init__(self, in_dim: int, out_dim: int, radius: float, kp_extent: float,
                 config_kp: dict, kp_seed: int = 0, ones_features: bool = False,
                 deformable: bool = False, modulated: bool = False):
        super().__init__()
        half = out_dim // 2
        self.KPConv = KPConv(in_dim, half, radius, kp_extent, seed=kp_seed,
                             ones_features=ones_features, deformable=deformable,
                             modulated=modulated, **config_kp)
        self.norm = NormBlock()

    def forward(self, x, q_pts, s_pts, neighb_inds, q_mask, s_mask, neighbors_rel=None,
                tile_meta=None, psum=None):
        x = self.KPConv(q_pts, s_pts, neighb_inds, x, neighbors_rel, tile_meta=tile_meta)
        return F.leaky_relu(self.norm(x, q_mask, psum), 0.1)


class ResnetBottleneckBlock(nn.Module):
    """1x1 down -> KPConv -> 1x1 up, with a shortcut that is max-pooled over
    the pool neighbors when strided (reference blocks.py:593-678):
    ``KPConv.strided`` returns it, by its route's rule
    (``models/kpconv.py::conv_route``)."""

    def __init__(self, in_dim: int, out_dim: int, radius: float, kp_extent: float,
                 config_kp: dict, strided: bool = False, kp_seed: int = 0,
                 deformable: bool = False, modulated: bool = False):
        super().__init__()
        quarter = out_dim // 4
        self.strided = strided
        self.unary1 = UnaryBlock(in_dim, quarter) if in_dim != quarter else None
        self.KPConv = KPConv(quarter, quarter, radius, kp_extent, seed=kp_seed,
                             deformable=deformable, modulated=modulated, **config_kp)
        self.norm_conv = NormBlock()
        self.unary2 = UnaryBlock(quarter, out_dim, no_relu=True)
        self.unary_shortcut = (
            UnaryBlock(in_dim, out_dim, no_relu=True) if in_dim != out_dim else None
        )

    def forward(self, x, q_pts, s_pts, neighb_inds, q_mask, s_mask, neighbors_rel=None,
                tile_meta=None, psum=None):
        y = self.unary1(x, s_mask, psum) if self.unary1 is not None else x
        if self.strided:
            y, shortcut = self.KPConv.strided(q_pts, s_pts, neighb_inds, y, x, neighbors_rel,
                                              tile_meta)
        else:
            y, shortcut = self.KPConv(q_pts, s_pts, neighb_inds, y, neighbors_rel,
                                      tile_meta=tile_meta), x
        y = F.leaky_relu(self.norm_conv(y, q_mask, psum), 0.1)
        y = self.unary2(y, q_mask, psum)
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_mask, psum)
        return F.leaky_relu(y + shortcut, 0.1)
