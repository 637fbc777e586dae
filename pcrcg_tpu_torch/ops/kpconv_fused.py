"""KPConv backward (K3): the weight gradient and the gathered-feature
gradient of the candidate-tile KPConv.

Counterpart of ``pcrcg_tpu/ops/kpconv_fused.py::_bwd_from_planes`` /
``_bwd_kernel`` as the backward of ``kpconv_tiled_ad`` runs it.  With g =
d loss / d out [Nq, D] (out before the division by nn), per query n:

    dW[k, c, d]  = Σ_n weighted[n, k, c] · g[n, d]
    gW[n, k, c]  = Σ_d W[k, c, d] · g[n, d]
    dnx[n, h, c] = Σ_k w[n, h, k] · gW[n, k, c]

``weighted`` [Nq, K·C] is the forward's phase-A output (kept by
``kpconv_tiled(keep_weighted=True)``); the influence weights w are
recomputed from rel = support row − query (shadow: −q) exactly as the
forward computes them.  dnx covers every neighbor slot, shadows included
(as the JAX kernel's does); the scatter (K4) drops the shadows.  On a CUDA
tensor ``kpconv_bwd`` launches ``csrc/kpconv_bwd.cu``; on a CPU tensor it
runs the plain version below.
"""
from __future__ import annotations

import torch

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.ops.kpconv_common import (
    INFLUENCE,
    check_geometry,
    compute_wgt,
    neighbor_rel,
)

_DW_BLOCKS_PER_SM = 4  # blocks per SM the dW product aims at
_DW_MIN_CHUNK = 256  # fewest queries a dW partial sums


def kpconv_bwd_plain(q_pts, s_pts, lidx, tiles, kernel_points, weights, g, weighted,
                     kp_extent: float, influence: str = "linear", aggregation: str = "sum",
                     tile: int = 128, need_dnx: bool = True):
    """Plain PyTorch version of K3 -> (dW [K, C, D], dnx [Nq, H, C] or None)."""
    k_count, c_in, d = weights.shape
    dw = (weighted.T @ g).reshape(k_count, c_in, d)
    if not need_dnx:
        return dw, None
    gw = (g @ weights.reshape(k_count * c_in, d).T).reshape(-1, k_count, c_in)
    rel, _, _ = neighbor_rel(q_pts, s_pts, lidx, tiles, tile)
    w = compute_wgt(rel, kernel_points, kp_extent, influence, aggregation)  # [Nq, H, K]
    return dw, torch.einsum("nhk,nkc->nhc", w, gw)


def _dw_chunk(nq: int, kc: int, d: int, sms: int) -> int:
    """Queries per dW partial: enough partials that the dW product fills the
    card's ``sms`` SMs even where dW itself has few 64 x 64 tiles (level 0)."""
    tiles = -(-kc // 64) * -(-d // 64)
    splits = max(1, -(-_DW_BLOCKS_PER_SM * sms // tiles))
    chunk = max(_DW_MIN_CHUNK, -(-nq // splits))
    return -(-chunk // 16) * 16


def kpconv_bwd(q_pts, s_pts, lidx, tiles, kernel_points, weights, g, weighted,
               kp_extent: float, influence: str = "linear", aggregation: str = "sum",
               tile: int = 128, need_dnx: bool = True):
    """K3: geometry as ``kpconv_tiled`` takes it, weights [K, C, D], g [Nq, D]
    f32, weighted [Nq, K·C] f32 -> (dW [K, C, D], dnx [Nq, H, C] f32, or None
    without ``need_dnx``)."""
    if q_pts.device.type == "cpu":
        return kpconv_bwd_plain(q_pts, s_pts, lidx, tiles, kernel_points, weights, g,
                                weighted, kp_extent, influence, aggregation, tile, need_dnx)
    dev = check_geometry(q_pts, s_pts, lidx, tiles, kernel_points, influence, aggregation)
    nq, ns = q_pts.shape[0], s_pts.shape[0]
    k_count, c_in, d = weights.shape
    h_count = lidx.shape[1]
    f32 = torch.float32
    kernels.require(weights, "weights", f32, dev)
    kernels.require(g, "g", f32, dev, (nq, d))
    kernels.require(weighted, "weighted", f32, dev, (nq, k_count * c_in))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = _dw_chunk(nq, k_count * c_in, d, sms)
    splits = -(-nq // chunk)
    partial = (torch.empty(splits, k_count * c_in, d, device=dev, dtype=f32)
               if splits > 1 else None)
    dw = torch.empty(k_count, c_in, d, device=dev, dtype=f32)
    gw = torch.empty(nq, k_count * c_in, device=dev, dtype=f32) if need_dnx else None
    dnx = torch.empty(nq, h_count, c_in, device=dev, dtype=f32) if need_dnx else None
    sigma = kp_extent * 0.3
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = kernels.bind("kpconv_bwd", "pcrcg_kpconv_bwd", "pipipipiipipiipp" "ffiii" "ppppp")(
        q_pts.data_ptr(), nq, s_pts.data_ptr(), ns, lidx.data_ptr(), h_count,
        tiles.data_ptr(), tiles.shape[1], tile, kernel_points.data_ptr(), k_count,
        weights.data_ptr(), c_in, d, g.data_ptr(), weighted.data_ptr(),
        float(kp_extent), float(2.0 * sigma**2 + 1e-9), INFLUENCE[influence],
        int(aggregation == "closest"), chunk, ptr(partial), dw.data_ptr(), ptr(gw),
        ptr(dnx), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "kpconv_bwd")
    kernels.count_launch("K3")
    return dw, dnx
