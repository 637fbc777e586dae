"""The gathered-feature KPConv (K6, K7) and the KPConv backward (K3).

Counterpart of ``pcrcg_tpu/ops/kpconv_fused.py``, with its contracts and
layouts: the neighbor features come gathered as ``nx_t`` [H, C, N] (shadow
rows zero), the geometry as ``rel`` [N, H, 3] (neighbor minus query; a
shadow at PAD_COORD − q, so zero influence) or, for the merged gather of
the strided blocks, as the gathered absolute coordinates in channel rows
0-2 of ``nxc_t`` [H, 8 + C, N].  Per query n:

    w[n, h, k]      = influence(|rel[n, h] − kp[k]|²)   (closest: nearest kp only)
    weighted[n,k,c] = Σ_h w[n, h, k] · nx_t[h, c, n]
    out[n]          = Σ_{k,c} weighted[n, k, c] · W[k, c]     (before ÷ nn)
    nn[n]           = max(1, #{h : Σ_c nx_t[h, c, n] > 0})

and the backward, with g = d loss / d out [N, D]:

    dW[k, c, d]  = Σ_n weighted[n, k, c] · g[n, d]
    gW[n, k, c]  = Σ_d W[k, c, d] · g[n, d]
    dnx[n, h, c] = Σ_k w[n, h, k] · gW[n, k, c]

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor, never falling back:

* ``kpconv_fused`` — K6: phase A, ``kpconv_gathered_reduce``
  (``csrc/kpconv_fused.cu``: influences, ``weighted_t`` [K·C, N] and nn in
  one pass over nx_t), then the W product on the tensor cores
  (``ops/tc_gemm.py::tc_gemm``, TRANS_A);
* ``kpconv_fused_merged`` — K7, the same source: rel from rows 0-2 minus
  q (a shadow gathers zeros, rel = −q); phase A, the product and nn skip
  the 8 coordinate/pad rows;
* ``kpconv_fused_bwd`` — K3's gathered entry, ``csrc/kpconv_bwd.cu``:
  ``weighted`` recomputed from ``nx_t``, then dW, gW (both on the tensor
  cores, ``csrc/tc_gemm.cuh``) and dnx_t.

``kpconv_bwd_plain`` is the plain version of K3's candidate-tile entry,
the backward of ``ops/kpconv_tiled.py::kpconv_tiled_ad``: ``weighted``
[Nq, K·C] is the forward's phase-A output (kept by
``kpconv_tiled(keep_weighted=True)``), the influences are recomputed from
rel = support row − query (shadow: −q), and dnx [Nq, H, C] covers every
slot, shadows included.  On the card that entry also scatters dnx onto
the support rows (K4) and never writes it: ``kpconv_tiled.py::
kpconv_tiled_bwd``.

``kpconv_fused_ad`` and ``kpconv_fused_merged_ad`` are the differentiable
convs (gradients to the features and W only; the geometry is fixed, nn is a
count), both with K3's gathered entry as their backward.  The gathers stay
outside the kernels, as the JAX wrappers leave them to XLA.
"""
from __future__ import annotations

import torch

from pcrcg_tpu_torch import kernels
from pcrcg_tpu_torch.ops.kpconv_common import (
    INFLUENCE,
    check_gathered,
    compute_wgt,
    neighbor_rel,
)
from pcrcg_tpu_torch.ops.tc_gemm import H100_SMS, plan_for, sm_count, tc_gemm, workspace

# Phase A's wide kernel (csrc/kpconv_gathered.cuh, kWideTileQ, kGroupC,
# kWideBlocksPerSm there): 16 queries a block, two blocks an SM, channels
# in groups of 64; C up to NARROW_C (kNarrowC) takes the narrow kernel.
TILE_Q = 16
GROUP_C = 64
NARROW_C = 4
BLOCKS_PER_SM = 2


def phase_a_split(c_feat: int, n: int, n_sm: int = H100_SMS) -> int:
    """The channel-group split (grid y) of phase A for C = ``c_feat``
    feature rows of ``n`` queries on ``n_sm`` SMs: 1 unless the 16-query
    blocks alone leave the card without BLOCKS_PER_SM blocks an SM; then
    the groups are cut into that many more blocks, none empty.  A split
    block adds its neighbor sums into a scratch plane, so more splits cost
    H x N floats each."""
    if c_feat <= NARROW_C:
        return 1
    groups = -(-c_feat // GROUP_C)
    want = -(-BLOCKS_PER_SM * n_sm // -(-n // TILE_Q))
    per = -(-groups // max(1, min(groups, want)))
    return -(-groups // per)


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


def _gathered_weighted(rel, nx_t, kernel_points, kp_extent, influence, aggregation):
    """Influences [N, H, K] and weighted [N, K·C] of the plain versions."""
    w = compute_wgt(rel, kernel_points, kp_extent, influence, aggregation)
    weighted = torch.einsum("nhk,hcn->nkc", w, nx_t)
    return w, weighted.reshape(weighted.shape[0], -1)


def _merged_rel(q_pts, nxc_t):
    """rel [N, H, 3] = gathered coordinates (rows 0-2 of nxc_t) − q."""
    return (nxc_t[:, :3, :] - q_pts.T[None]).permute(2, 0, 1)


def kpconv_gathered_reduce_plain(geom, nx_t, c_skip: int, kernel_points, kp_extent: float,
                                 influence: str = "linear", aggregation: str = "sum"):
    """Plain PyTorch version of phase A -> (weighted_t [K·C, N], nn [N]) for
    the C = nx_t.shape[1] − c_skip feature rows; ``geom`` is rel [N, H, 3]
    (c_skip 0) or, for the merged gather, q_pts [N, 3] (rel from rows 0-2)."""
    rel = _merged_rel(geom, nx_t) if geom.dim() == 2 else geom
    feats = nx_t[:, c_skip:, :]
    _, weighted = _gathered_weighted(rel, feats, kernel_points, kp_extent, influence,
                                     aggregation)
    nn = (feats.sum(1) > 0.0).sum(0).clamp_min(1).to(weighted.dtype)
    return weighted.T, nn


def kpconv_fused_plain(rel, nx_t, kernel_points, weights, kp_extent: float,
                       influence: str = "linear", aggregation: str = "sum"):
    """Plain PyTorch version of K6 -> (out [N, D] before the ÷nn, nn [N]):
    phase A, then the W product."""
    k_count, c_in, d = weights.shape
    weighted_t, nn = kpconv_gathered_reduce_plain(rel, nx_t, 0, kernel_points, kp_extent,
                                                  influence, aggregation)
    return weighted_t.T @ weights.reshape(k_count * c_in, d), nn


def kpconv_gathered_reduce(geom, nx_t, c_skip: int, kernel_points, kp_extent: float,
                           influence: str = "linear", aggregation: str = "sum"):
    """Phase A of K6 (``geom`` rel [N, H, 3], c_skip 0) and of K7 (``geom``
    q_pts [N, 3], c_skip 8) -> (weighted_t [K·C, N] f32, nn [N] f32) over the
    C = nx_t.shape[1] − c_skip feature rows; bit for bit the same on every
    run.  The CUDA launch of ``kpconv_fused``'s and ``kpconv_fused_merged``'s
    first half (``csrc/kpconv_fused.cu``); the launch count is theirs."""
    if nx_t.device.type == "cpu":
        return kpconv_gathered_reduce_plain(geom, nx_t, c_skip, kernel_points, kp_extent,
                                            influence, aggregation)
    merged = geom.dim() == 2
    dev = check_gathered(nx_t, kernel_points, influence, aggregation,
                         **({"q_pts": geom} if merged else {"rel": geom}))
    h_count, c_total, n = nx_t.shape
    c_feat = c_total - c_skip
    if c_feat <= 0 or c_skip < (3 if merged else 0):
        raise ValueError(f"nx_t {tuple(nx_t.shape)} with c_skip {c_skip}: no feature rows, "
                         "or the coordinates are not skipped")
    k_count = kernel_points.shape[0]
    f32 = torch.float32
    split = phase_a_split(c_feat, n, sm_count(dev.index))
    nn_part = torch.empty(split * h_count * n, device=dev, dtype=f32) if split > 1 else None
    weighted_t = torch.empty(k_count * c_feat, n, device=dev, dtype=f32)
    nn = torch.empty(n, device=dev, dtype=f32)
    sigma = kp_extent * 0.3
    err = kernels.bind("kpconv_fused", "pcrcg_kpconv_gathered_reduce", "ppp" "iiii" "pi" "ffii"
                       "ipppp")(
        None if merged else geom.data_ptr(), geom.data_ptr() if merged else None,
        nx_t.data_ptr(), n, h_count, c_total, c_skip, kernel_points.data_ptr(), k_count,
        float(kp_extent), float(2.0 * sigma**2 + 1e-9), INFLUENCE[influence],
        int(aggregation == "closest"), split, None if nn_part is None else nn_part.data_ptr(),
        weighted_t.data_ptr(), nn.data_ptr(), kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "kpconv_fused phase A")
    return weighted_t, nn


def _launch_fused(geom, nx_t, c_skip, kernel_points, w_rows, kp_extent, influence,
                  aggregation, kernel_id):
    """K6 / K7 on the card: phase A, then out [N, D] = weighted_tᵀ @ w_rows
    (W's C feature rows [K·C, D]) on the tensor cores (``tc_gemm``'s TRANS_A
    layout, ``plan_for``'s split-K plan) -> (out, nn)."""
    weighted_t, nn = kpconv_gathered_reduce(geom, nx_t, c_skip, kernel_points, kp_extent,
                                            influence, aggregation)
    out = tc_gemm(weighted_t, w_rows, trans_a=True)
    kernels.count_launch(kernel_id)
    return out, nn


def kpconv_fused(rel, nx_t, kernel_points, weights, kp_extent: float,
                 influence: str = "linear", aggregation: str = "sum"):
    """K6: rel [N, H, 3] f32, nx_t [H, C, N] f32 (shadow rows zero),
    kernel_points [K, 3], weights [K, C, D] -> (out [N, D] before the ÷nn,
    nn [N] f32)."""
    if nx_t.device.type == "cpu":
        return kpconv_fused_plain(rel, nx_t, kernel_points, weights, kp_extent, influence,
                                  aggregation)
    kernels.require(weights, "weights", torch.float32, nx_t.device,
                    (kernel_points.shape[0], nx_t.shape[1], weights.shape[-1]))
    return _launch_fused(rel, nx_t, 0, kernel_points, weights.reshape(-1, weights.shape[-1]),
                         kp_extent, influence, aggregation, "K6")


def kpconv_fused_merged_plain(q_pts, nxc_t, kernel_points, weights8, kp_extent: float,
                              influence: str = "linear", aggregation: str = "sum"):
    """Plain PyTorch version of K7 -> (out [N, D] before the ÷nn, nn [N]);
    nn counts the feature-only sums (rows ≥ 8)."""
    k_count, c8, d = weights8.shape
    _, weighted = _gathered_weighted(_merged_rel(q_pts, nxc_t), nxc_t, kernel_points,
                                     kp_extent, influence, aggregation)
    out = weighted @ weights8.reshape(k_count * c8, d)
    nn = (nxc_t[:, 8:, :].sum(1) > 0.0).sum(0).clamp_min(1).to(out.dtype)
    return out, nn


def kpconv_fused_merged(q_pts, nxc_t, kernel_points, weights8, kp_extent: float,
                        influence: str = "linear", aggregation: str = "sum"):
    """K7: q_pts [N, 3], nxc_t [H, 8 + C, N] the merged gather [coords | 0 |
    features] (shadow rows all zero), weights8 [K, 8 + C, D] with its first
    8 channel rows zero -> (out [N, D] before the ÷nn, nn [N] f32).  On the
    card the kernel reduces and contracts the C feature rows only (K·C, not
    K·(8 + C)): the same output, since W8's first 8 rows are zero."""
    if nxc_t.device.type == "cpu":
        return kpconv_fused_merged_plain(q_pts, nxc_t, kernel_points, weights8, kp_extent,
                                         influence, aggregation)
    kernels.require(weights8, "weights8", torch.float32, nxc_t.device,
                    (kernel_points.shape[0], nxc_t.shape[1], weights8.shape[-1]))
    # The kernel skips the 8 coordinate/pad rows, so it takes W8's feature
    # rows (its first 8 rows are zero by contract).
    w_rows = weights8[:, 8:, :].reshape(-1, weights8.shape[-1]).contiguous()
    return _launch_fused(q_pts, nxc_t, 8, kernel_points, w_rows, kp_extent, influence,
                         aggregation, "K7")


def kpconv_fused_bwd_plain(rel, nx_t, g, kernel_points, weights, kp_extent: float,
                           influence: str = "linear", aggregation: str = "sum",
                           need_dnx: bool = True):
    """Plain PyTorch version of K3's gathered entry -> (dnx_t [H, C, N] or
    None without ``need_dnx``, dW [K, C, D])."""
    k_count, c_in, d = weights.shape
    w, weighted = _gathered_weighted(rel, nx_t, kernel_points, kp_extent, influence,
                                     aggregation)
    dw = (weighted.T @ g).reshape(k_count, c_in, d)
    if not need_dnx:
        return None, dw
    gw = (g @ weights.reshape(k_count * c_in, d).T).reshape(-1, k_count, c_in)
    return torch.einsum("nhk,nkc->hcn", w, gw), dw


def kpconv_fused_bwd(rel, nx_t, g, kernel_points, weights, kp_extent: float,
                     influence: str = "linear", aggregation: str = "sum",
                     need_dnx: bool = True):
    """K3, gathered entry: rel [N, H, 3], nx_t [H, C, N] (the forward's
    gathered features), g [N, D], kernel_points [K, 3], weights [K, C, D],
    all f32 -> (dnx_t [H, C, N] f32, or None without ``need_dnx``, dW
    [K, C, D] f32)."""
    if nx_t.device.type == "cpu":
        return kpconv_fused_bwd_plain(rel, nx_t, g, kernel_points, weights, kp_extent,
                                      influence, aggregation, need_dnx)
    dev = check_gathered(nx_t, kernel_points, influence, aggregation, rel=rel)
    h_count, c_in, n = nx_t.shape
    k_count, _, d = weights.shape
    f32 = torch.float32
    kernels.require(weights, "weights", f32, dev, (k_count, c_in, d))
    kernels.require(g, "g", f32, dev, (n, d))
    kc = k_count * c_in
    dw_plan = plan_for(kc, d, n, dev)  # dW = weighted_t @ g
    gw_plan = plan_for(kc, n, d, dev)  # gW_t = W @ g^T
    ws = workspace(dev, (dw_plan, kc, d), *([(gw_plan, kc, n)] if need_dnx else []))
    weighted_t = torch.empty(kc, n, device=dev, dtype=f32)
    dw = torch.empty(k_count, c_in, d, device=dev, dtype=f32)
    gw_t = torch.empty(kc, n, device=dev, dtype=f32) if need_dnx else None
    dnx_t = torch.empty(h_count, c_in, n, device=dev, dtype=f32) if need_dnx else None
    sigma = kp_extent * 0.3
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = kernels.bind("kpconv_bwd", "pcrcg_kpconv_fused_bwd",
                       "ppiiipipip" "ffii" "iiiii" "pppppp")(
        rel.data_ptr(), nx_t.data_ptr(), n, h_count, c_in, kernel_points.data_ptr(), k_count,
        weights.data_ptr(), d, g.data_ptr(), float(kp_extent), float(2.0 * sigma**2 + 1e-9),
        INFLUENCE[influence], int(aggregation == "closest"),
        phase_a_split(c_in, n, sm_count(dev.index)), *dw_plan, *gw_plan,
        weighted_t.data_ptr(), ptr(ws), dw.data_ptr(), ptr(gw_t), ptr(dnx_t),
        kernels.stream_handle(dev),
    )
    kernels.check_launch(err, "kpconv_fused_bwd")
    kernels.count_launch("K3")
    return dnx_t, dw


class _KPConvFusedFn(torch.autograd.Function):
    """K6 forward; backward K3's gathered entry (dnx_t, dW)."""

    @staticmethod
    def forward(ctx, rel, nx_t, kernel_points, weights, kp_extent, influence, aggregation,
                needs_dnx):
        out, nn = kpconv_fused(rel, nx_t, kernel_points, weights, kp_extent, influence,
                               aggregation)
        ctx.save_for_backward(rel, nx_t, kernel_points, weights)
        ctx.conf = (kp_extent, influence, aggregation, needs_dnx)
        ctx.mark_non_differentiable(nn)
        return out, nn

    @staticmethod
    def backward(ctx, g_out, _g_nn):
        rel, nx_t, kernel_points, weights = ctx.saved_tensors
        kp_extent, influence, aggregation, needs_dnx = ctx.conf
        dnx_t, dw = kpconv_fused_bwd(rel, nx_t, g_out.contiguous(), kernel_points, weights,
                                     kp_extent, influence, aggregation,
                                     need_dnx=needs_dnx and ctx.needs_input_grad[1])
        return (None, dnx_t, None, dw if ctx.needs_input_grad[3] else None,
                None, None, None, None)


def kpconv_fused_ad(rel, nx_t, kernel_points, weights, kp_extent: float,
                    influence: str = "linear", aggregation: str = "sum",
                    needs_dnx: bool = True):
    """Differentiable ``kpconv_fused``: gradients flow to ``nx_t`` and
    ``weights`` only (rel and the kernel points are fixed geometry, nn is a
    count), as the JAX package's ``kpconv_fused_ad``.  ``needs_dnx=False``
    skips the feature gradient (the ones-column input, whose features are
    constants)."""
    return _KPConvFusedFn.apply(rel, nx_t, kernel_points, weights, float(kp_extent),
                                influence, aggregation, needs_dnx)


class _KPConvFusedMergedFn(torch.autograd.Function):
    """K7 forward; backward K3's gathered entry over the whole merged gather
    (the coordinate rows meet W8's zero rows, so their dnx_t is zero)."""

    @staticmethod
    def forward(ctx, q_pts, nxc_t, kernel_points, weights8, kp_extent, influence,
                aggregation, needs_dnx):
        out, nn = kpconv_fused_merged(q_pts, nxc_t, kernel_points, weights8, kp_extent,
                                      influence, aggregation)
        ctx.save_for_backward(q_pts, nxc_t, kernel_points, weights8)
        ctx.conf = (kp_extent, influence, aggregation, needs_dnx)
        ctx.mark_non_differentiable(nn)
        return out, nn

    @staticmethod
    def backward(ctx, g_out, _g_nn):
        q_pts, nxc_t, kernel_points, weights8 = ctx.saved_tensors
        kp_extent, influence, aggregation, needs_dnx = ctx.conf
        rel = _merged_rel(q_pts, nxc_t).contiguous()
        dnx_t, dw = kpconv_fused_bwd(rel, nxc_t, g_out.contiguous(), kernel_points, weights8,
                                     kp_extent, influence, aggregation,
                                     need_dnx=needs_dnx and ctx.needs_input_grad[1])
        return (None, dnx_t, None, dw if ctx.needs_input_grad[3] else None,
                None, None, None, None)


def kpconv_fused_merged_ad(q_pts, nxc_t, kernel_points, weights8, kp_extent: float,
                           influence: str = "linear", aggregation: str = "sum",
                           needs_dnx: bool = True):
    """Differentiable ``kpconv_fused_merged``: gradients flow to ``nxc_t``
    and ``weights8`` only, as the JAX package's ``kpconv_fused_merged_ad``."""
    return _KPConvFusedMergedFn.apply(q_pts, nxc_t, kernel_points, weights8,
                                      float(kp_extent), influence, aggregation, needs_dnx)


def kpconv_gathered_fused(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                          kp_extent: float, influence: str = "linear",
                          aggregation: str = "sum", neighbors_rel=None,
                          ones_features: bool = False):
    """A whole non-strided KPConv through K6, under the JAX package's name:
    ``models/kpconv.py::kpconv(..., impl="fused")``, which it calls (the
    path the model runs).  q_pts [Nq, 3], s_pts [Ns, 3], neighb_inds
    [Nq, H], x [Ns, C] -> [Nq, D]."""
    from pcrcg_tpu_torch.models.kpconv import kpconv  # that module imports this one

    return kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent, influence,
                  aggregation, neighbors_rel=neighbors_rel, ones_features=ones_features,
                  impl="fused")
