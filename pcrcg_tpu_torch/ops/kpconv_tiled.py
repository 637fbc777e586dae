"""Candidate-tile KPConv: forward (K2), its autograd (backward K3 + K4), and
the strided-shortcut max-pool with its backward (K5).

Counterpart of ``pcrcg_tpu/ops/kpconv_tiled.py``.  The neighbors of query
n are given tile-locally, as the tiled search returns them: ``lidx[n, h]``
is a position inside the M·tile candidate block of n's 128-query group,
whose tiles are ``tiles[n // 128]``; ``M·tile`` is the shadow (zero
feature, rel = −q).  Per query:

    rel[h]      = s[row(n, h)] − q[n]
    w[h, k]     = influence(|rel[h] − kp[k]|²)        (closest: nearest kp only)
    weighted[k] = Σ_h w[h, k] · feats[row(n, h)]
    out[n]      = Σ_k weighted[k] · W[k]             ([K·C] x [K·C, D])
    nn[n]       = max(1, #{h : Σ_c feats[row(n, h), c] > 0})

``out`` is returned before the division by ``nn``, the contract of the
JAX kernel.  Each wrapper runs its plain PyTorch version for a CPU tensor
and launches its CUDA kernel for a CUDA tensor, never falling back:

* ``kpconv_tiled`` — K2, ``csrc/kpconv_tiled.cu``, two launches: phase A
  (``kpconv_tiled_reduce``: gather + influence + reduce into ``weighted``)
  and phase B (``ops/tc_gemm.py::tc_gemm``: the W contraction on the
  tensor cores, error-compensated TF32, fp32-grade);
* ``kpconv_tiled_bwd`` — K3's candidate-tile entry with K4 folded in,
  ``csrc/kpconv_bwd.cu``: dW and gW on the tensor cores
  (``csrc/tc_gemm.cuh``), then dnx (K3) scattered straight onto the
  support rows, ``ds[row(n, h)] += dnx[n, h]`` (K4), so dnx is never
  written; its plain version is K3's (``kpconv_fused.py::
  kpconv_bwd_plain``) then K4's (``scatter_ds_feats_plain``);
* ``maxpool_bwd`` — K5, ``csrc/tile_scatter.cu``: the max-pool gradient
  to the first-maximum neighbor.

``kpconv_tiled_ad`` is the differentiable conv (gradients to the features
and W only, as the JAX package's ``stop_gradient``s give); its backward
is ``kpconv_tiled_bwd``.
"""
from __future__ import annotations

import torch

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.ops.kpconv_common import (
    INFLUENCE,
    check_geometry,
    compute_wgt,
    neighbor_rel,
    support_rows,
)
from pcrcg_tpu_torch.ops.kpconv_fused import kpconv_bwd_plain
from pcrcg_tpu_torch.ops.masked import pad_gather
from pcrcg_tpu_torch.ops.tc_gemm import plan_for, tc_gemm, workspace


def kpconv_tiled_reduce_plain(q_pts, s_pts, s_feats, lidx, tiles, kernel_points,
                              k_count: int, kp_extent: float, influence: str = "linear",
                              aggregation: str = "sum", tile: int = 128):
    """Plain PyTorch version of phase A: -> (weighted [Nq, K·C], nn [Nq])."""
    nq, c_in = q_pts.shape[0], s_feats.shape[1]
    rel, row, vf = neighbor_rel(q_pts, s_pts, lidx, tiles, tile)
    feats = s_feats[row] * vf  # [Nq, H, C], shadow rows zero
    w = compute_wgt(rel, kernel_points, kp_extent, influence, aggregation)
    weighted = torch.einsum("nhk,nhc->nkc", w, feats).reshape(nq, k_count * c_in)
    nn = (feats.sum(-1) > 0.0).sum(-1).clamp_min(1).to(weighted.dtype)
    return weighted, nn


def kpconv_tiled_plain(q_pts, s_pts, s_feats, lidx, tiles, kernel_points, weights,
                       kp_extent: float, influence: str = "linear",
                       aggregation: str = "sum", tile: int = 128,
                       keep_weighted: bool = False):
    """Plain PyTorch version of the kernel: -> (out [Nq, D], nn [Nq]), and
    weighted [Nq, K·C] with ``keep_weighted``."""
    k_count, c_in, d = weights.shape
    weighted, nn = kpconv_tiled_reduce_plain(q_pts, s_pts, s_feats, lidx, tiles,
                                             kernel_points, k_count, kp_extent, influence,
                                             aggregation, tile)
    out = weighted @ weights.reshape(k_count * c_in, d)
    return (out, nn, weighted) if keep_weighted else (out, nn)


def kpconv_tiled_reduce(q_pts, s_pts, s_feats, lidx, tiles, kernel_points, k_count: int,
                        kp_extent: float, influence: str = "linear",
                        aggregation: str = "sum", tile: int = 128):
    """K2's phase A: -> (weighted [Nq, K·C], nn [Nq]), bit for bit the same
    on every run.  The CUDA launch of ``kpconv_tiled``'s first half; the
    launch count is ``kpconv_tiled``'s."""
    if q_pts.device.type == "cpu":
        return kpconv_tiled_reduce_plain(q_pts, s_pts, s_feats, lidx, tiles, kernel_points,
                                         k_count, kp_extent, influence, aggregation, tile)
    dev = check_geometry(q_pts, s_pts, lidx, tiles, kernel_points, influence, aggregation)
    nq, ns = q_pts.shape[0], s_pts.shape[0]
    c_in = s_feats.shape[1]
    kernels.require(s_feats, "s_feats", torch.float32, dev, (ns, c_in))
    if kernel_points.shape[0] != k_count:
        raise ValueError(f"{kernel_points.shape[0]} kernel points, weights have {k_count}")
    weighted = torch.empty(nq, k_count * c_in, device=dev, dtype=torch.float32)
    nn = torch.empty(nq, device=dev, dtype=torch.float32)
    rowsum = torch.empty(ns, device=dev, dtype=torch.float32)  # scratch
    sigma = kp_extent * 0.3
    err = kernels.bind("kpconv_tiled", "pcrcg_kpconv_tiled_reduce", "pipipipipiipiffiipppp")(
        q_pts.data_ptr(), nq, s_pts.data_ptr(), ns, s_feats.data_ptr(), c_in,
        lidx.data_ptr(), lidx.shape[1], tiles.data_ptr(), tiles.shape[1], tile,
        kernel_points.data_ptr(), k_count, float(kp_extent), float(2.0 * sigma**2 + 1e-9),
        INFLUENCE[influence], int(aggregation == "closest"), rowsum.data_ptr(),
        weighted.data_ptr(), nn.data_ptr(), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "kpconv_tiled phase A")
    return weighted, nn


def kpconv_tiled(q_pts, s_pts, s_feats, lidx, tiles, kernel_points, weights,
                 kp_extent: float, influence: str = "linear",
                 aggregation: str = "sum", tile: int = 128, keep_weighted: bool = False):
    """q_pts [Nq,3], s_pts [Ns,3], s_feats [Ns,C] f32, lidx [G·128,H] int32,
    tiles [G,M] int32, kernel_points [K,3], weights [K,C,D] ->
    (out [Nq,D] before the ÷nn, nn [Nq] f32), plus phase A's weighted
    [Nq, K·C] with ``keep_weighted`` (the backward's dW input)."""
    if q_pts.device.type == "cpu":
        return kpconv_tiled_plain(q_pts, s_pts, s_feats, lidx, tiles, kernel_points,
                                  weights, kp_extent, influence, aggregation, tile,
                                  keep_weighted)
    k_count, c_in, d = weights.shape
    kernels.require(weights, "weights", torch.float32, q_pts.device)
    weighted, nn = kpconv_tiled_reduce(q_pts, s_pts, s_feats, lidx, tiles, kernel_points,
                                       k_count, kp_extent, influence, aggregation, tile)
    out = tc_gemm(weighted, weights.reshape(k_count * c_in, d))
    kernels.count_launch("K2")
    return (out, nn, weighted) if keep_weighted else (out, nn)


def scatter_ds_feats_plain(dnx, lidx, tiles, ns: int, tile: int = 128):
    """Plain PyTorch version of K4: dnx [Nq, H, C] -> ds [Ns, C] with
    ds[row(n, h)] = Σ dnx[n, h] over the real neighbors."""
    nq, _, c_in = dnx.shape
    row, valid = support_rows(lidx, tiles, nq, ns, tile)
    ds = torch.zeros(ns, c_in, device=dnx.device, dtype=dnx.dtype)
    return ds.index_add_(0, row[valid], dnx[valid])


def kpconv_tiled_bwd_plain(q_pts, s_pts, lidx, tiles, kernel_points, weights, g, weighted,
                           kp_extent: float, influence: str = "linear",
                           aggregation: str = "sum", tile: int = 128, need_ds: bool = True):
    """Plain PyTorch version of ``kpconv_tiled_bwd``: K3's
    (``kpconv_bwd_plain``), then K4's (``scatter_ds_feats_plain``) ->
    (dW [K, C, D], ds [Ns, C] or None)."""
    dw, dnx = kpconv_bwd_plain(q_pts, s_pts, lidx, tiles, kernel_points, weights, g, weighted,
                               kp_extent, influence, aggregation, tile, need_dnx=need_ds)
    if not need_ds:
        return dw, None
    return dw, scatter_ds_feats_plain(dnx, lidx, tiles, s_pts.shape[0], tile)


def kpconv_tiled_bwd(q_pts, s_pts, lidx, tiles, kernel_points, weights, g, weighted,
                     kp_extent: float, influence: str = "linear", aggregation: str = "sum",
                     tile: int = 128, need_ds: bool = True):
    """K3's candidate-tile entry with K4 folded in: geometry as
    ``kpconv_tiled`` takes it, weights [K, C, D], g [Nq, D] f32, weighted
    [Nq, K·C] f32 (the forward's phase A) -> (dW [K, C, D] f32, bit for bit
    the same on every run; ds [Ns, C] f32, the feature gradient, atomic
    sums in an order that varies run to run, or None without
    ``need_ds``).  Counts a launch of K3 and, with ``need_ds``, of K4."""
    if q_pts.device.type == "cpu":
        return kpconv_tiled_bwd_plain(q_pts, s_pts, lidx, tiles, kernel_points, weights, g,
                                      weighted, kp_extent, influence, aggregation, tile,
                                      need_ds)
    dev = check_geometry(q_pts, s_pts, lidx, tiles, kernel_points, influence, aggregation)
    nq, ns = q_pts.shape[0], s_pts.shape[0]
    k_count, c_in, d = weights.shape
    kc = k_count * c_in
    f32 = torch.float32
    kernels.require(weights, "weights", f32, dev)
    kernels.require(g, "g", f32, dev, (nq, d))
    kernels.require(weighted, "weighted", f32, dev, (nq, kc))
    dw_plan = plan_for(kc, d, nq, dev)  # dW = weighted^T @ g
    gw_plan = plan_for(nq, kc, d, dev)  # gW = g @ W^T
    ws = workspace(dev, (dw_plan, kc, d), *([(gw_plan, nq, kc)] if need_ds else []))
    dw = torch.empty(k_count, c_in, d, device=dev, dtype=f32)
    gw = torch.empty(nq, kc, device=dev, dtype=f32) if need_ds else None
    ds = torch.empty(ns, c_in, device=dev, dtype=f32) if need_ds else None  # zeroed by the launch
    sigma = kp_extent * 0.3
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = kernels.bind("kpconv_bwd", "pcrcg_kpconv_bwd",
                       "pipipipiipipiipp" "ffii" "iiii" "ppppp")(
        q_pts.data_ptr(), nq, s_pts.data_ptr(), ns, lidx.data_ptr(), lidx.shape[1],
        tiles.data_ptr(), tiles.shape[1], tile, kernel_points.data_ptr(), k_count,
        weights.data_ptr(), c_in, d, g.data_ptr(), weighted.data_ptr(),
        float(kp_extent), float(2.0 * sigma**2 + 1e-9), INFLUENCE[influence],
        int(aggregation == "closest"), *dw_plan, *gw_plan, ptr(ws), dw.data_ptr(), ptr(gw),
        ptr(ds), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "kpconv_tiled_bwd")
    kernels.count_launch("K3")
    if need_ds:
        kernels.count_launch("K4")
    return dw, ds


class _KPConvTiledFn(torch.autograd.Function):
    """K2 forward keeping ``weighted``; backward K3 with K4 folded in."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, s_feats, weights, lidx, tiles, kernel_points,
                kp_extent, influence, aggregation, tile):
        out, nn, weighted = kpconv_tiled(q_pts, s_pts, s_feats, lidx, tiles, kernel_points,
                                         weights, kp_extent, influence, aggregation, tile,
                                         keep_weighted=True)
        ctx.save_for_backward(q_pts, s_pts, lidx, tiles, kernel_points, weights, weighted)
        ctx.conf = (kp_extent, influence, aggregation, tile)
        ctx.mark_non_differentiable(nn)
        return out, nn

    @staticmethod
    def backward(ctx, g_out, _g_nn):
        q_pts, s_pts, lidx, tiles, kernel_points, weights, weighted = ctx.saved_tensors
        kp_extent, influence, aggregation, tile = ctx.conf
        dw, ds = kpconv_tiled_bwd(
            q_pts, s_pts, lidx, tiles, kernel_points, weights, g_out.contiguous(), weighted,
            kp_extent, influence, aggregation, tile, need_ds=ctx.needs_input_grad[2],
        )
        return (None, None, ds, dw if ctx.needs_input_grad[3] else None,
                None, None, None, None, None, None, None)


def kpconv_tiled_ad(q_pts, s_pts, s_feats, lidx, tiles, kernel_points, weights,
                    kp_extent: float, influence: str = "linear",
                    aggregation: str = "sum", tile: int = 128):
    """Differentiable ``kpconv_tiled``: gradients flow to ``s_feats`` and
    ``weights`` only (geometry and kernel points are fixed, nn is a count),
    as the JAX package's ``kpconv_tiled_ad``.  Without a gradient to take
    no graph is built and the kept ``weighted`` is freed on return."""
    return _KPConvTiledFn.apply(q_pts, s_pts, s_feats, weights, lidx, tiles, kernel_points,
                                float(kp_extent), influence, aggregation, tile)


def maxpool_bwd_plain(g, amax, inds, ns: int):
    """Plain PyTorch version of K5's backward: g [Nq, C], amax [Nq, C] int64
    (neighbor slot of the first maximum), inds [Nq, H] int64 (pad ≥ Ns) ->
    ds [Ns, C] with ds[inds[q, amax[q, c]], c] += g[q, c], shadows dropped."""
    c_in = g.shape[1]
    rows = inds.gather(1, amax)  # [Nq, C]
    valid = (rows >= 0) & (rows < ns)
    flat = rows * c_in + torch.arange(c_in, device=g.device)
    ds = torch.zeros(ns * c_in, device=g.device, dtype=g.dtype)
    return ds.index_add_(0, flat[valid], g[valid]).reshape(ns, c_in)


def maxpool_bwd(g, amax, inds, ns: int):
    """K5: g [Nq, C] f32, amax [Nq, C] int64, inds [Nq, H] int64 -> ds [Ns, C]
    f32 (atomic sums: the order varies run to run)."""
    if g.device.type == "cpu":
        return maxpool_bwd_plain(g, amax, inds, ns)
    dev = g.device
    nq, c_in = g.shape
    kernels.require(g, "g", torch.float32, dev)
    kernels.require(amax, "amax", torch.int64, dev, (nq, c_in))
    kernels.require(inds, "inds", torch.int64, dev)
    if inds.shape[0] != nq:
        raise ValueError(f"inds {tuple(inds.shape)} does not fit g {tuple(g.shape)}")
    ds = torch.empty(ns, c_in, device=dev, dtype=torch.float32)  # zeroed by the launch
    err = kernels.bind("tile_scatter", "pcrcg_maxpool_bwd", "pppiiiipp")(
        g.data_ptr(), amax.data_ptr(), inds.data_ptr(), nq, inds.shape[1], c_in, ns,
        ds.data_ptr(), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "maxpool_bwd")
    kernels.count_launch("K5")
    return ds


class _MaxPoolTiledFn(torch.autograd.Function):
    """Gather + max over the neighbors (shadow rows are 0); backward K5 to
    the first maximum."""

    @staticmethod
    def forward(ctx, x, inds):
        out, amax = pad_gather(x, inds, 0.0).max(dim=1)  # first maximum on ties
        ctx.save_for_backward(amax, inds)
        ctx.ns = x.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        amax, inds = ctx.saved_tensors
        return maxpool_bwd(g.contiguous(), amax, inds, ctx.ns), None


def max_pool_tiled(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Strided-shortcut max-pool: x [Ns, C], inds [Nq, H] int64 (pad ≥ Ns)
    -> [Nq, C].  Its gradient goes whole to the first maximal neighbor
    (the JAX package's ``max_pool_tiled`` / ``jnp.argmax`` rule), through
    K5 on the card."""
    return _MaxPoolTiledFn.apply(x, inds)
