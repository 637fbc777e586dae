// Candidate-tile KPConv backward (K3).
//
// Replaces the Pallas TPU kernel pcrcg_tpu/ops/kpconv_fused.py::_bwd_kernel
// (via _bwd_from_planes), as the backward of kpconv_tiled_ad uses it.  Given
// g = d loss / d out [Nq, D] (out taken before the division by nn):
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
#include <cuda_runtime.h>

#include "kpconv_common.cuh"
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
  const int splits = nq > 0 ? (nq + k_chunk - 1) / k_chunk : 1;
  if (splits > 1 && dw_partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = pcrcg::launch_sgemm<true, false>(kc, d, nq, k_chunk, weighted, g,
                                                   splits > 1 ? dw_partial : dW, st);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t n = (size_t)kc * d;
    size_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    sum_partials_kernel<<<(int)blocks, kThreads, 0, st>>>(dw_partial, splits, n, dW);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
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
