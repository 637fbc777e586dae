"""KPConv influence + neighbor reduce without the W contraction (K8).

Counterpart of ``pcrcg_tpu/ops/kpconv_pallas.py``, with its contract and
layout: rel [N, H, 3] (neighbor minus query), the gathered features nx
[N, H, C] (shadow rows zero) ->

    weighted[k, n, c] = Σ_h influence(|rel[n, h] − kp[k]|²) · nx[n, h, c]
    nn[n]             = max(1, #{h : Σ_c nx[n, h, c] > 0})

(sum aggregation only).  It is the kernel of ``kpconv_impl='reduce'``,
which serves only: the JAX package defines no VJP for it.  On a CUDA tensor
``kpconv_weighted_reduce`` launches ``csrc/kpconv_reduce.cu``; on a CPU
tensor it runs the plain version below.
"""
from __future__ import annotations

import torch

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.ops.kpconv_common import INFLUENCE, K_MAX, compute_wgt


def kpconv_weighted_reduce_plain(rel, nx, kernel_points, kp_extent: float,
                                 influence: str = "linear"):
    """Plain PyTorch version of K8 -> (weighted [K, N, C], nn [N])."""
    w = compute_wgt(rel, kernel_points, kp_extent, influence, "sum")  # [N, H, K]
    weighted = torch.einsum("nhk,nhc->knc", w, nx)
    nn = (nx.sum(-1) > 0.0).sum(-1).clamp_min(1).to(weighted.dtype)
    return weighted, nn


def kpconv_weighted_reduce(rel, nx, kernel_points, kp_extent: float,
                           influence: str = "linear"):
    """K8: rel [N, H, 3] f32, nx [N, H, C] f32, kernel_points [K, 3] ->
    (weighted [K, N, C] f32, nn [N] f32)."""
    if nx.device.type == "cpu":
        return kpconv_weighted_reduce_plain(rel, nx, kernel_points, kp_extent, influence)
    dev = nx.device
    if nx.dim() != 3:
        raise ValueError(f"nx must be [N, H, C], got {tuple(nx.shape)}")
    n, h_count, c_in = nx.shape
    k_count = kernel_points.shape[0]
    if k_count > K_MAX:
        raise ValueError(f"the kernels hold at most {K_MAX} kernel points, got {k_count}")
    if influence not in INFLUENCE:
        raise ValueError(f"unsupported influence: {influence}")
    f32 = torch.float32
    kernels.require(nx, "nx", f32, dev)
    kernels.require(rel, "rel", f32, dev, (n, h_count, 3))
    kernels.require(kernel_points, "kernel_points", f32, dev, (k_count, 3))
    weighted = torch.empty(k_count, n, c_in, device=dev, dtype=f32)
    nn = torch.empty(n, device=dev, dtype=f32)
    sigma = kp_extent * 0.3
    err = kernels.bind("kpconv_reduce", "pcrcg_kpconv_weighted_reduce", "ppiiipiffippp")(
        rel.data_ptr(), nx.data_ptr(), n, h_count, c_in, kernel_points.data_ptr(), k_count,
        float(kp_extent), float(2.0 * sigma**2 + 1e-9), INFLUENCE[influence],
        weighted.data_ptr(), nn.data_ptr(), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "kpconv_weighted_reduce")
    kernels.count_launch("K8")
    return weighted, nn
