"""What the candidate-tile KPConv forward (K2) and backward (K3, K4) share:
the neighbor rows resolved from the tile-local ``lidx`` / ``tiles``, the
influence weights, and the checks on the geometry every kernel reads.

The Python side of ``csrc/kpconv_common.cuh``: the plain versions use these
functions, and the CUDA kernels compute the same quantities in the same
order.
"""
from __future__ import annotations

import torch

from pcrcg_tpu_torch import kernels

GROUP = 128  # queries per group (the tiled search's group size)
K_MAX = 16  # kernel points the CUDA kernels hold per thread
INFLUENCE = {"constant": 0, "linear": 1, "gaussian": 2}


def influence_fn(d2: torch.Tensor, kp_extent: float, influence: str) -> torch.Tensor:
    if influence == "linear":
        return torch.clamp(1.0 - torch.sqrt(d2.clamp_min(0.0)) / kp_extent, min=0.0)
    if influence == "gaussian":
        sigma = kp_extent * 0.3
        return torch.exp(-d2 / (2.0 * sigma**2 + 1e-9))
    if influence == "constant":
        return torch.ones_like(d2)
    raise ValueError(f"Unknown KP influence: {influence}")


def compute_wgt(rel: torch.Tensor, kernel_points: torch.Tensor, kp_extent: float,
                influence: str, aggregation: str) -> torch.Tensor:
    """Influence weights [..., H, K] from rel [..., H, 3] with the expanded
    |rel|² − 2 rel·kp + |kp|² distance of the JAX kernels."""
    rx, ry, rz = (rel[..., i, None] for i in range(3))
    kx, ky, kz = kernel_points.unbind(-1)
    rel_sq = rx * rx + ry * ry + rz * rz
    d2 = rel_sq - 2.0 * (rx * kx + ry * ky + rz * kz) + (kx * kx + ky * ky + kz * kz)
    w = influence_fn(d2, kp_extent, influence)
    if aggregation == "closest":
        w = torch.where(d2 <= d2.amin(-1, keepdim=True), w, 0.0)
    elif aggregation != "sum":
        raise ValueError(f"Unknown aggregation mode: {aggregation}")
    return w


def support_rows(lidx: torch.Tensor, tiles: torch.Tensor, nq: int, ns: int, tile: int):
    """Global support row per (query, neighbor) and its validity."""
    m_tiles = tiles.shape[1]
    l = lidx[:nq].long()
    group = (torch.arange(nq, device=lidx.device) // GROUP)[:, None]
    real = l < m_tiles * tile
    tile_id = tiles.long()[group, (l // tile).clamp(max=m_tiles - 1)]
    row = tile_id * tile + l % tile
    valid = real & (row < ns)
    return torch.where(valid, row, 0), valid


def neighbor_rel(q_pts, s_pts, lidx, tiles, tile: int):
    """rel [Nq, H, 3] = support row − query (shadow: −q), the rows and their
    validity."""
    row, valid = support_rows(lidx, tiles, q_pts.shape[0], s_pts.shape[0], tile)
    vf = valid[..., None].to(s_pts.dtype)
    return s_pts[row] * vf - q_pts[:, None, :], row, vf


def check_geometry(q_pts, s_pts, lidx, tiles, kernel_points, influence, aggregation):
    """Validate what every candidate-tile kernel reads; returns the device."""
    dev = q_pts.device
    nq, ns = q_pts.shape[0], s_pts.shape[0]
    g_count = tiles.shape[0]
    k_count = kernel_points.shape[0]
    if k_count > K_MAX:
        raise ValueError(f"the kernels hold at most {K_MAX} kernel points, got {k_count}")
    if lidx.shape[0] != g_count * GROUP or nq > g_count * GROUP:
        raise ValueError(f"lidx {tuple(lidx.shape)} / {nq} queries do not fit {g_count} groups")
    if influence not in INFLUENCE or aggregation not in ("sum", "closest"):
        raise ValueError(f"unsupported influence/aggregation: {influence}/{aggregation}")
    f32, i32 = torch.float32, torch.int32
    kernels.require(q_pts, "q_pts", f32, dev, (nq, 3))
    kernels.require(s_pts, "s_pts", f32, dev, (ns, 3))
    kernels.require(lidx, "lidx", i32, dev)
    kernels.require(tiles, "tiles", i32, dev)
    kernels.require(kernel_points, "kernel_points", f32, dev, (k_count, 3))
    return dev
