// KPConv backward (K3), in two entries: the candidate-tile one
// (pcrcg_kpconv_bwd, which also does K4's scatter) and the gathered-feature
// one (pcrcg_kpconv_fused_bwd).
//
// Replaces the Pallas TPU kernel pcrcg_tpu/ops/kpconv_fused.py::_bwd_kernel
// (via _bwd_from_planes), as the backward of kpconv_tiled_ad uses it
// (candidate tiles) and as kpconv_fused_bwd, the backward of
// kpconv_fused_ad and kpconv_fused_merged_ad, uses it (gathered features,
// described at the end of this note).  Given g = d loss / d out [Nq, D]
// (out taken before the division by nn):
//
//   dW[k, c, d]   = sum_n weighted[n, k, c] g[n, d]          (dW = weighted^T g)
//   gW[n, k, c]   = sum_d W[k, c, d] g[n, d]                 (gW = g W^T)
//   dnx[n, h, c]  = sum_k w[n, h, k] gW[n, k, c]
//
// The candidate-tile entry goes on to the feature gradient, which the TPU
// path takes in K4 (pcrcg_tpu/ops/kpconv_tiled.py::_dcand_kernel and the
// XLA _tile_block_scatter after it):
//
//   ds[row(n, h), c] += dnx[n, h, c]      (shadow neighbors dropped)
//
// `weighted` [Nq, K*C] is K2's phase-A output, kept by the forward.  The
// influence weights w are recomputed here from rel = support row - query
// (shadow: -q), with the expanded distance of the JAX kernels
// (kpconv_common.cuh).
//
// The TPU kernel streamed the gathered features nx [H, C, N] through VMEM
// and kept the dW accumulator resident across query tiles, because its grid
// runs in order on one core.  Here blocks run in parallel, so the two
// products are split out as GEMMs on the tensor cores (tc_gemm.cuh:
// error-compensated TF32, fp32-grade, on the split-K plans of
// ops/tc_gemm.py::plan_gemm, partials summed in a fixed order, so dW is
// bit-identical run to run):
//   - dW: the TRANS_A layout (weighted is stored [Nq, K*C]), the Nq
//     reduction cut into up to ~200 partials (at level 0 dW has only 8
//     128 x 64 tiles);
//   - gW: the TRANS_B layout (W is stored [K*C, D]) into an [Nq, K*C]
//     scratch;
//   - dnx_scatter_kernel: one warp per (query, neighbor) resolves the
//     support row and recomputes the K influences into shared memory,
//     then threads over (query, channel) hold gW[n, :, c] in registers,
//     take dnx[n, h, c] for each neighbor and atomicAdd it into ds[row, c]
//     (coalesced over c), so dnx is never written: K4's work, and its
//     second resolve of each row, folded into K3.  The atomics' order
//     varies run to run, as K4's did: ds is held to a relative tolerance.
// With ds null (the ones-column input of block 0) only dW runs.
//
// What bounds it on the H100: the two products' operations (2 x 2 Nq K C D:
// 24 GFLOP for a level-3 512 x 512 conv, as three TF32 passes 0.15 ms at
// 495 TFLOP/s) and, at level 0, the bytes of `weighted` and the gW
// scratch (Nq x K C fp32: 204 MB each for the (64, 64) conv).
//
// The gathered entry computes what _bwd_kernel computes from rel [N, H, 3]
// and the forward's gathered features nx_t [H, C, N]: it recomputes
// weighted from nx_t (K6's phase A, kpconv_gathered.cuh, written transposed
// as weighted_t [K*C, N]), takes dW = weighted_t x g (the row-major layout,
// split-K as above), gW_t [K*C, N] = W x g^T (the TRANS_B layout: g is
// stored [N, D]), and writes dnx_t [H, C, N] from the same recomputed
// influences (gathered_dnx_kernel: lanes on queries, so the gW_t reads and
// dnx_t writes are coalesced).  Bound at level 0: the bytes of nx_t read
// and dnx_t written (545 MB each for the (64, 64) conv); at levels 2-3 the
// products' operations.
#include <cuda_runtime.h>

#include "kpconv_common.cuh"
#include "kpconv_gathered.cuh"
#include "tc_gemm.cuh"

namespace {

using pcrcg::kKMax;
using pcrcg::tc::gemm_3xtf32;
constexpr int kThreads = 256;

// ds[row(n, h), c] += sum_k w[n, h, k] gW[n, k, c] for the qpb queries at
// blockIdx.x * qpb (shadow rows dropped).
__global__ void dnx_scatter_kernel(const float* __restrict__ q, int nq,
                                   const float* __restrict__ s, int ns,
                                   const int* __restrict__ lidx, int h_count,
                                   const int* __restrict__ tiles, int m_tiles, int tile,
                                   const float* __restrict__ kp, int k_count, int c_in,
                                   float extent, float gauss_denom, int influence, int closest,
                                   int qpb, const float* __restrict__ gW,
                                   float* __restrict__ ds) {
  extern __shared__ float wsm[];  // [qpb][H][kKMax] influences, then [qpb][H] rows
  int* rows = reinterpret_cast<int*>(wsm + (size_t)qpb * h_count * kKMax);
  const int n0 = blockIdx.x * qpb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // One warp per (query, neighbor): its support row (-1: shadow) and the
  // K influence weights by lane.
  for (int p = warp; p < qpb * h_count; p += nwarps) {
    const int qi = p / h_count;
    const int h = p - qi * h_count;
    const int n = n0 + qi;
    float w = 0.0f;
    int row = -1;
    if (n < nq) {
      row = pcrcg::support_row(lidx, tiles, n, h, h_count, m_tiles, tile, ns);
      const float qx = q[3 * (size_t)n], qy = q[3 * (size_t)n + 1], qz = q[3 * (size_t)n + 2];
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      if (row >= 0) {
        sx = s[3 * (size_t)row];
        sy = s[3 * (size_t)row + 1];
        sz = s[3 * (size_t)row + 2];
      }
      w = pcrcg::lane_influence(__fsub_rn(sx, qx), __fsub_rn(sy, qy), __fsub_rn(sz, qz), kp,
                                k_count, lane, influence, extent, gauss_denom, closest);
    }
    if (lane < kKMax) wsm[(qi * h_count + h) * kKMax + lane] = (lane < k_count) ? w : 0.0f;
    if (lane == 0) rows[qi * h_count + h] = row;
  }
  __syncthreads();

  // Threads over (query, channel): dnx[n, h, c] = sum_k w[h, k] gW[n, k, c],
  // added into its support row.
  const int kc = k_count * c_in;
  for (int idx = threadIdx.x; idx < qpb * c_in; idx += blockDim.x) {
    const int qi = idx / c_in;
    const int c = idx - qi * c_in;
    const int n = n0 + qi;
    if (n >= nq) continue;
    float gw[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) gw[k] = k < k_count ? gW[(size_t)n * kc + k * c_in + c] : 0.0f;
    for (int h = 0; h < h_count; ++h) {
      const int row = rows[qi * h_count + h];
      if (row < 0) continue;
      const float* wp = wsm + (qi * h_count + h) * kKMax;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) acc = fmaf(wp[k], gw[k], acc);
      atomicAdd(ds + (size_t)row * c_in + c, acc);
    }
  }
}

// dnx_t[h, c, n] = sum_k w[n, h, k] gW_t[k * C + c, n] for the tile of 32
// queries at blockIdx.x * kTileQ: the influences recomputed into shared
// memory as phase A computes them, then a warp per channel, lanes on
// queries.
__global__ void gathered_dnx_kernel(const float* __restrict__ rel, int n, int h_count,
                                    int c_in, const float* __restrict__ kp, int k_count,
                                    float extent, float gauss_denom, int influence, int closest,
                                    const float* __restrict__ gW_t, float* __restrict__ dnx_t) {
  using pcrcg::kTileQ;
  extern __shared__ float wsm[];  // [H][kKMax][kTileQ]
  const int n0 = blockIdx.x * kTileQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nq = n0 + lane;
  pcrcg::tile_influences(wsm, rel, nullptr, nullptr, n, h_count, c_in, n0, kp, k_count,
                         influence, extent, gauss_denom, closest);
  __syncthreads();
  if (nq >= n) return;
  for (int c = warp; c < c_in; c += nwarps) {
    float gw[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      gw[k] = k < k_count ? gW_t[((size_t)k * c_in + c) * n + nq] : 0.0f;
    }
    float* out = dnx_t + (size_t)c * n + nq;
    for (int h = 0; h < h_count; ++h) {
      const float* wp = wsm + h * kKMax * kTileQ + lane;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) acc = fmaf(wp[k * kTileQ], gw[k], acc);
      out[(size_t)h * c_in * n] = acc;
    }
  }
}

}  // namespace

// q [nq, 3], s [ns, 3], lidx [>= nq, h_count] int32, tiles [groups, m_tiles]
// int32, kp [k_count, 3], W [k_count * c_in, d], g [nq, d], weighted
// [nq, k_count * c_in].  Outputs dW [k_count * c_in, d] and, when ds is not
// null, ds [ns, c_in], zero-filled here first (a memset on `stream`); gW
// [nq, k_count * c_in] is scratch.  The products run on the split-K plans
// (dw_splits, dw_chunk) and (gw_splits, gw_chunk) of ops/tc_gemm.py, one
// after the other on `stream`, sharing `workspace` (the larger of their
// splits x M x N floats; null when neither splits).  Returns a CUDA error
// code after the launches.
extern "C" int pcrcg_kpconv_bwd(const float* q, int nq, const float* s, int ns,
                                const int* lidx, int h_count, const int* tiles, int m_tiles,
                                int tile, const float* kp, int k_count, const float* W,
                                int c_in, int d, const float* g, const float* weighted,
                                float extent, float gauss_denom, int influence, int closest,
                                int dw_splits, int dw_chunk, int gw_splits, int gw_chunk,
                                float* workspace, float* dW, float* gW, float* ds,
                                void* stream) {
  if (k_count > kKMax || k_count <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kc = k_count * c_in;
  cudaError_t e = gemm_3xtf32<true, false>(kc, d, nq, dw_splits, dw_chunk, weighted, g, dW,
                                           workspace, st);
  if (e != cudaSuccess || ds == nullptr) return (int)e;
  e = cudaMemsetAsync(ds, 0, (size_t)ns * c_in * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  e = gemm_3xtf32<false, true>(nq, kc, d, gw_splits, gw_chunk, g, W, gW, workspace, st);
  if (e != cudaSuccess) return (int)e;

  const size_t per_query = (size_t)h_count * (kKMax * sizeof(float) + sizeof(int));
  int qpb = kThreads / (c_in > 0 ? c_in : 1);
  qpb = qpb < 1 ? 1 : (qpb > 16 ? 16 : qpb);
  while (qpb > 1 && qpb * per_query > 48 * 1024) --qpb;
  const size_t smem = qpb * per_query;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(dnx_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dnx_scatter_kernel<<<(nq + qpb - 1) / qpb, kThreads, smem, st>>>(
      q, nq, s, ns, lidx, h_count, tiles, m_tiles, tile, kp, k_count, c_in, extent,
      gauss_denom, influence, closest, qpb, gW, ds);
  return (int)cudaGetLastError();
}

// The gathered entry.  rel [n, h_count, 3], nx_t [h_count, c_in, n] (the
// forward's gathered features), kp [k_count, 3], W [k_count * c_in, d],
// g [n, d].  Outputs dW [k_count * c_in, d] and, when dnx_t is not null,
// dnx_t [h_count, c_in, n]; weighted_t and (with dnx_t) gW_t, both
// [k_count * c_in, n], are scratch, and the plans and workspace as in
// pcrcg_kpconv_bwd.  Returns a CUDA error code after the launches on
// `stream`.
extern "C" int pcrcg_kpconv_fused_bwd(const float* rel, const float* nx_t, int n, int h_count,
                                      int c_in, const float* kp, int k_count, const float* W,
                                      int d, const float* g, float extent, float gauss_denom,
                                      int influence, int closest, int dw_splits, int dw_chunk,
                                      int gw_splits, int gw_chunk, float* weighted_t,
                                      float* workspace, float* dW, float* gW_t, float* dnx_t,
                                      void* stream) {
  if (k_count > kKMax || k_count <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kc = k_count * c_in;
  cudaError_t e = pcrcg::launch_gathered_reduce(rel, nullptr, nx_t, n, h_count, c_in, 0, kp,
                                                k_count, extent, gauss_denom, influence,
                                                closest, weighted_t, nullptr, st);
  if (e != cudaSuccess) return (int)e;
  e = gemm_3xtf32<false, false>(kc, d, n, dw_splits, dw_chunk, weighted_t, g, dW, workspace,
                                st);
  if (e != cudaSuccess || dnx_t == nullptr) return (int)e;
  e = gemm_3xtf32<false, true>(kc, n, d, gw_splits, gw_chunk, W, g, gW_t, workspace, st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = pcrcg::gathered_smem_bytes(h_count);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gathered_dnx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gathered_dnx_kernel<<<(n + pcrcg::kTileQ - 1) / pcrcg::kTileQ, pcrcg::kGatheredThreads, smem,
                        st>>>(rel, n, h_count, c_in, kp, k_count, extent, gauss_denom,
                              influence, closest, gW_t, dnx_t);
  return (int)cudaGetLastError();
}
