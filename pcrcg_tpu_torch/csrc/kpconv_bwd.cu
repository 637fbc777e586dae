// KPConv backward (K3), in two entries: the candidate-tile one
// (pcrcg_kpconv_bwd) and the gathered-feature one (pcrcg_kpconv_fused_bwd).
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
// `weighted` [Nq, K*C] is K2's phase-A output, kept by the forward.  The
// influence weights w are recomputed here from rel = support row - query
// (shadow: -q), with the expanded distance of the JAX kernels
// (kpconv_common.cuh).  dnx is written for every neighbor slot, shadows
// included, as the TPU kernel writes it; the scatter (K4) drops shadows.
//
// The TPU kernel streamed the gathered features nx [H, C, N] through VMEM
// and kept the dW accumulator resident across query tiles, because its grid
// runs in order on one core.  Here blocks run in parallel, so the two
// products are split out as GEMMs (sgemm.cuh, written by hand, fp32):
//   - dW: a transposed-A GEMM with the Nq reduction cut into chunks
//     (split-K), one partial per chunk, summed in fixed order by
//     sum_partials_kernel (deterministic; at level 0 dW has only 15 64x64
//     tiles, too few blocks to fill the card's SMs without the split);
//   - gW: a transposed-B GEMM into an [Nq, K*C] scratch;
//   - dnx_kernel: one warp per (query, neighbor) recomputes the K
//     influences into shared memory, then threads over (query, channel)
//     hold gW[n, :, c] in registers and write dnx[n, h, c] coalesced.
// With need_dnx off (the ones-column input of block 0) only dW runs.
//
// What bounds it on the H100: the products' operations at the wide levels
// (4 Nq K C D flops: 24 GFLOP for a level-3 512 x 512 conv, 0.36 ms at
// 67 TFLOP/s fp32); at level 0 the bytes of dnx (Nq x H x C fp32: 545 MB
// for the (64, 64) conv, 0.16 ms at 3.35 TB/s).  Fusing dnx into K4's
// scatter (so it is never written) and wgmma tiles are later work.
//
// The gathered entry computes what _bwd_kernel computes from rel [N, H, 3]
// and the forward's gathered features nx_t [H, C, N]: it recomputes
// weighted from nx_t (K6's phase A, kpconv_gathered.cuh, written transposed
// as weighted_t [K*C, N]), takes dW = weighted_t x g as the same split-K
// product, gW_t [K*C, N] = W x g^T, and writes dnx_t [H, C, N] from the
// same recomputed influences (gathered_dnx_kernel: lanes on queries, so
// the gW_t reads and dnx_t writes are coalesced).  Bound at level 0: the
// bytes of nx_t read and dnx_t written (545 MB each for the (64, 64)
// conv); at levels 2-3 the products' operations.
#include <cuda_runtime.h>

#include "kpconv_common.cuh"
#include "kpconv_gathered.cuh"
#include "sgemm.cuh"

namespace {

using pcrcg::kKMax;
constexpr int kThreads = 256;

__global__ void sum_partials_kernel(const float* __restrict__ partial, int splits, size_t n,
                                    float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < splits; ++z) acc += partial[(size_t)z * n + i];
    out[i] = acc;
  }
}

__global__ void dnx_kernel(const float* __restrict__ q, int nq, const float* __restrict__ s,
                           int ns, const int* __restrict__ lidx, int h_count,
                           const int* __restrict__ tiles, int m_tiles, int tile,
                           const float* __restrict__ kp, int k_count, int c_in, float extent,
                           float gauss_denom, int influence, int closest, int qpb,
                           const float* __restrict__ gW, float* __restrict__ dnx) {
  extern __shared__ float wsm[];  // [qpb][H][kKMax]
  const int n0 = blockIdx.x * qpb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // One warp per (query, neighbor): the K influence weights by lane.
  for (int p = warp; p < qpb * h_count; p += nwarps) {
    const int qi = p / h_count;
    const int h = p - qi * h_count;
    const int n = n0 + qi;
    float w = 0.0f;
    if (n < nq) {
      const int row = pcrcg::support_row(lidx, tiles, n, h, h_count, m_tiles, tile, ns);
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
  }
  __syncthreads();

  // Threads over (query, channel): dnx[n, h, c] = sum_k w[h, k] gW[n, k, c].
  const int kc = k_count * c_in;
  for (int idx = threadIdx.x; idx < qpb * c_in; idx += blockDim.x) {
    const int qi = idx / c_in;
    const int c = idx - qi * c_in;
    const int n = n0 + qi;
    if (n >= nq) continue;
    float gw[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) gw[k] = k < k_count ? gW[(size_t)n * kc + k * c_in + c] : 0.0f;
    float* out = dnx + (size_t)n * h_count * c_in + c;
    for (int h = 0; h < h_count; ++h) {
      const float* wp = wsm + (qi * h_count + h) * kKMax;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) acc = fmaf(wp[k], gw[k], acc);
      out[(size_t)h * c_in] = acc;
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

// dW = a [kc, nq] x g [nq, d] (TRANS_A: a stored [nq, kc]) as a split-K
// product over chunks of k_chunk queries, the partials summed in fixed
// order; returns cudaGetLastError().
template <bool TRANS_A>
cudaError_t weight_grad(int kc, int d, int nq, int k_chunk, const float* a, const float* g,
                        float* dw_partial, float* dW, cudaStream_t st) {
  const int splits = nq > 0 ? (nq + k_chunk - 1) / k_chunk : 1;
  if (splits > 1 && dw_partial == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = pcrcg::launch_sgemm<TRANS_A, false>(kc, d, nq, k_chunk, a, g,
                                                      splits > 1 ? dw_partial : dW, st);
  if (e != cudaSuccess || splits <= 1) return e;
  const size_t n = (size_t)kc * d;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  sum_partials_kernel<<<(int)blocks, kThreads, 0, st>>>(dw_partial, splits, n, dW);
  return cudaGetLastError();
}

}  // namespace

// q [nq, 3], s [ns, 3], lidx [>= nq, h_count] int32, tiles [groups, m_tiles]
// int32, kp [k_count, 3], W [k_count * c_in, d], g [nq, d], weighted
// [nq, k_count * c_in].  Outputs dW [k_count * c_in, d] and, when dnx is not
// null, dnx [nq, h_count, c_in] (gW [nq, k_count * c_in] is scratch).  The
// dW reduction over nq runs in chunks of k_chunk queries; when that makes
// more than one chunk, dw_partial [ceil(nq / k_chunk), k_count * c_in, d]
// holds the partials.  Returns cudaGetLastError() after the launches on
// `stream`.
extern "C" int pcrcg_kpconv_bwd(const float* q, int nq, const float* s, int ns,
                                const int* lidx, int h_count, const int* tiles, int m_tiles,
                                int tile, const float* kp, int k_count, const float* W,
                                int c_in, int d, const float* g, const float* weighted,
                                float extent, float gauss_denom, int influence, int closest,
                                int k_chunk, float* dw_partial, float* dW, float* gW,
                                float* dnx, void* stream) {
  if (k_count > kKMax || k_count <= 0 || k_chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kc = k_count * c_in;
  cudaError_t e = weight_grad<true>(kc, d, nq, k_chunk, weighted, g, dw_partial, dW, st);
  if (e != cudaSuccess) return (int)e;
  if (dnx == nullptr || nq <= 0) return 0;

  e = pcrcg::launch_sgemm<false, true>(nq, kc, d, d, g, W, gW, st);
  if (e != cudaSuccess) return (int)e;

  int qpb = kThreads / (c_in > 0 ? c_in : 1);
  qpb = qpb < 1 ? 1 : (qpb > 16 ? 16 : qpb);
  while (qpb > 1 && (size_t)qpb * h_count * kKMax * sizeof(float) > 48 * 1024) --qpb;
  const size_t smem = (size_t)qpb * h_count * kKMax * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(dnx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dnx_kernel<<<(nq + qpb - 1) / qpb, kThreads, smem, st>>>(
      q, nq, s, ns, lidx, h_count, tiles, m_tiles, tile, kp, k_count, c_in, extent,
      gauss_denom, influence, closest, qpb, gW, dnx);
  return (int)cudaGetLastError();
}

// The gathered entry.  rel [n, h_count, 3], nx_t [h_count, c_in, n] (the
// forward's gathered features), kp [k_count, 3], W [k_count * c_in, d],
// g [n, d].  Outputs dW [k_count * c_in, d] and, when dnx_t is not null,
// dnx_t [h_count, c_in, n]; weighted_t and (with dnx_t) gW_t, both
// [k_count * c_in, n], are scratch, and dw_partial as in pcrcg_kpconv_bwd.
// Returns cudaGetLastError() after the launches on `stream`.
extern "C" int pcrcg_kpconv_fused_bwd(const float* rel, const float* nx_t, int n, int h_count,
                                      int c_in, const float* kp, int k_count, const float* W,
                                      int d, const float* g, float extent, float gauss_denom,
                                      int influence, int closest, int k_chunk,
                                      float* weighted_t, float* dw_partial, float* dW,
                                      float* gW_t, float* dnx_t, void* stream) {
  if (k_count > kKMax || k_count <= 0 || k_chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kc = k_count * c_in;
  cudaError_t e = cudaSuccess;
  if (n > 0) {
    e = pcrcg::launch_gathered_reduce(rel, nullptr, nx_t, n, h_count, c_in, 0, kp, k_count,
                                      extent, gauss_denom, influence, closest, weighted_t,
                                      nullptr, st);
    if (e != cudaSuccess) return (int)e;
  }
  e = weight_grad<false>(kc, d, n, k_chunk, weighted_t, g, dw_partial, dW, st);
  if (e != cudaSuccess) return (int)e;
  if (dnx_t == nullptr || n <= 0) return 0;

  e = pcrcg::launch_sgemm<false, true>(kc, n, d, d, W, g, gW_t, st);
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
