"""Candidate-tile KPConv forward (K2).

Counterpart of ``pcrcg_tpu/ops/kpconv_tiled.py::kpconv_tiled``.  The
neighbors of query n are given tile-locally, as the tiled search returns
them: ``lidx[n, h]`` is a position inside the M·tile candidate block of
n's 128-query group, whose tiles are ``tiles[n // 128]``; ``M·tile`` is
the shadow (zero feature, rel = −q).  Per query:

    rel[h]      = s[row(n, h)] − q[n]
    w[h, k]     = influence(|rel[h] − kp[k]|²)        (closest: nearest kp only)
    weighted[k] = Σ_h w[h, k] · feats[row(n, h)]
    out[n]      = Σ_k weighted[k] · W[k]             ([K·C] x [K·C, D])
    nn[n]       = max(1, #{h : Σ_c feats[row(n, h), c] > 0})

``out`` is returned before the division by ``nn``, the contract of the
JAX kernel.  On a CUDA tensor ``kpconv_tiled`` launches
``csrc/kpconv_tiled.cu`` (gather + influence + reduce, then a hand-written
fp32 GEMM for the W contraction); on a CPU tensor it runs the plain
version below.
"""
from __future__ import annotations

import ctypes

import torch

from pcrcg_tpu_torch import kernels

_T = 128  # queries per group (the tiled search's group size)
_K_MAX = 16  # kernel points the CUDA kernel holds per thread
_INFLUENCE = {"constant": 0, "linear": 1, "gaussian": 2}
LAUNCHES = 0  # CUDA launches of the kernel (the plain version does not count)


def _influence_fn(d2: torch.Tensor, kp_extent: float, influence: str) -> torch.Tensor:
    if influence == "linear":
        return torch.clamp(1.0 - torch.sqrt(d2.clamp_min(0.0)) / kp_extent, min=0.0)
    if influence == "gaussian":
        sigma = kp_extent * 0.3
        return torch.exp(-d2 / (2.0 * sigma**2 + 1e-9))
    if influence == "constant":
        return torch.ones_like(d2)
    raise ValueError(f"Unknown KP influence: {influence}")


def _compute_wgt(rel: torch.Tensor, kernel_points: torch.Tensor, kp_extent: float,
                 influence: str, aggregation: str) -> torch.Tensor:
    """Influence weights [..., H, K] from rel [..., H, 3] with the expanded
    |rel|² − 2 rel·kp + |kp|² distance of the JAX kernels."""
    rx, ry, rz = (rel[..., i, None] for i in range(3))
    kx, ky, kz = kernel_points.unbind(-1)
    rel_sq = rx * rx + ry * ry + rz * rz
    d2 = rel_sq - 2.0 * (rx * kx + ry * ky + rz * kz) + (kx * kx + ky * ky + kz * kz)
    w = _influence_fn(d2, kp_extent, influence)
    if aggregation == "closest":
        w = torch.where(d2 <= d2.amin(-1, keepdim=True), w, 0.0)
    elif aggregation != "sum":
        raise ValueError(f"Unknown aggregation mode: {aggregation}")
    return w


def _support_rows(lidx: torch.Tensor, tiles: torch.Tensor, nq: int, ns: int, tile: int):
    """Global support row per (query, neighbor) and its validity."""
    m_tiles = tiles.shape[1]
    l = lidx[:nq].long()
    group = (torch.arange(nq, device=lidx.device) // _T)[:, None]
    real = l < m_tiles * tile
    tile_id = tiles.long()[group, (l // tile).clamp(max=m_tiles - 1)]
    row = tile_id * tile + l % tile
    valid = real & (row < ns)
    return torch.where(valid, row, 0), valid


def kpconv_tiled_plain(q_pts, s_pts, s_feats, lidx, tiles, kernel_points, weights,
                       kp_extent: float, influence: str = "linear",
                       aggregation: str = "sum", tile: int = 128):
    """Plain PyTorch version of the kernel: -> (out [Nq, D], nn [Nq])."""
    nq, ns = q_pts.shape[0], s_pts.shape[0]
    k_count, c_in, d = weights.shape
    row, valid = _support_rows(lidx, tiles, nq, ns, tile)
    vf = valid[..., None].to(s_pts.dtype)
    rel = s_pts[row] * vf - q_pts[:, None, :]  # shadow: -q
    feats = s_feats[row] * vf  # [Nq, H, C], shadow rows zero
    w = _compute_wgt(rel, kernel_points, kp_extent, influence, aggregation)
    weighted = torch.einsum("nhk,nhc->nkc", w, feats).reshape(nq, k_count * c_in)
    out = weighted @ weights.reshape(k_count * c_in, d)
    nn = (feats.sum(-1) > 0.0).sum(-1).clamp_min(1).to(out.dtype)
    return out, nn


def kpconv_tiled(q_pts, s_pts, s_feats, lidx, tiles, kernel_points, weights,
                 kp_extent: float, influence: str = "linear",
                 aggregation: str = "sum", tile: int = 128):
    """q_pts [Nq,3], s_pts [Ns,3], s_feats [Ns,C] f32, lidx [G·128,H] int32,
    tiles [G,M] int32, kernel_points [K,3], weights [K,C,D] ->
    (out [Nq,D] before the ÷nn, nn [Nq] f32)."""
    if q_pts.device.type == "cpu":
        return kpconv_tiled_plain(q_pts, s_pts, s_feats, lidx, tiles, kernel_points,
                                  weights, kp_extent, influence, aggregation, tile)
    global LAUNCHES
    dev = q_pts.device
    nq, ns = q_pts.shape[0], s_pts.shape[0]
    k_count, c_in, d = weights.shape
    h_count = lidx.shape[1]
    g_count, m_tiles = tiles.shape
    if k_count > _K_MAX:
        raise ValueError(f"the kernel holds at most {_K_MAX} kernel points, got {k_count}")
    if lidx.shape[0] != g_count * _T or nq > g_count * _T:
        raise ValueError(f"lidx {tuple(lidx.shape)} / {nq} queries do not fit {g_count} groups")
    if influence not in _INFLUENCE or aggregation not in ("sum", "closest"):
        raise ValueError(f"unsupported influence/aggregation: {influence}/{aggregation}")
    f32, i32 = torch.float32, torch.int32
    kernels.require(q_pts, "q_pts", f32, dev, (nq, 3))
    kernels.require(s_pts, "s_pts", f32, dev, (ns, 3))
    kernels.require(s_feats, "s_feats", f32, dev, (ns, c_in))
    kernels.require(lidx, "lidx", i32, dev)
    kernels.require(tiles, "tiles", i32, dev)
    kernels.require(kernel_points, "kernel_points", f32, dev, (k_count, 3))
    kernels.require(weights, "weights", f32, dev)
    weighted = torch.empty(nq, k_count * c_in, device=dev, dtype=f32)  # scratch
    out = torch.empty(nq, d, device=dev, dtype=f32)
    nn = torch.empty(nq, device=dev, dtype=f32)
    sigma = kp_extent * 0.3
    err = _lib().pcrcg_kpconv_tiled(
        q_pts.data_ptr(), nq, s_pts.data_ptr(), ns, s_feats.data_ptr(), c_in,
        lidx.data_ptr(), h_count, tiles.data_ptr(), m_tiles, tile,
        kernel_points.data_ptr(), k_count, weights.data_ptr(), d,
        float(kp_extent), float(2.0 * sigma**2 + 1e-9), _INFLUENCE[influence],
        int(aggregation == "closest"), weighted.data_ptr(), out.data_ptr(),
        nn.data_ptr(), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "kpconv_tiled")
    LAUNCHES += 1
    return out, nn


def _lib():
    lib = kernels.library("kpconv_tiled")
    fn = lib.pcrcg_kpconv_tiled
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, i, p, i, p, i, p, i, i, p, i, p, i, f, f, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib
