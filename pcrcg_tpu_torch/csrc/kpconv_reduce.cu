// KPConv influence + neighbor reduce without the W contraction (K8).
//
// Replaces the Pallas TPU kernel pcrcg_tpu/ops/kpconv_pallas.py::_kernel_2d
// (wrapper kpconv_weighted_reduce), the kernel of kpconv_impl='reduce'.
// Per query n, from rel [N, H, 3] and the gathered features nx [N, H, C]
// (shadow rows zero):
//
//   weighted[k, n, c] = sum_h influence(|rel[n, h] - kp[k]|^2) nx[n, h, c]
//   nn[n]             = max(1, #{h : sum_c nx[n, h, c] > 0})
//
// sum aggregation only, as the TPU kernel.  The W contraction follows
// outside the kernel (torch.matmul in the port, an einsum in XLA in the
// JAX package).
//
// The TPU kernel ran a (query tile, kernel point) grid, re-reading each
// VMEM-resident nx tile once per kernel point.  Here a block takes `qpb`
// queries (as K2's phase A does, kpconv_tiled.cu): one warp per (query,
// neighbor) computes the K influences (lane = kernel point) into shared
// memory and the neighbor's feature sum (lanes over channels); then the
// threads walk (query, channel) pairs -- nx is query-major, so neighbouring
// threads read neighbouring channels -- with K accumulators each, reading
// nx once and writing weighted [K, N, C] coalesced.
//
// What bounds it on the H100: bytes.  It reads nx once (545 MB for a level-0
// (64, 64) conv: 0.16 ms at 3.35 TB/s) and writes weighted, K = 15 times
// the size of one [N, C] output (204 MB at level 0); its operations (2 K
// per nx element) are ~1/10 of the card's fp32 rate at that traffic.
#include <cuda_runtime.h>

#include "kpconv_common.cuh"

namespace {

using pcrcg::kKMax;
constexpr int kThreads = 256;

__global__ void weighted_reduce_kernel(const float* __restrict__ rel,
                                       const float* __restrict__ nx, int n, int h_count,
                                       int c_in, const float* __restrict__ kp, int k_count,
                                       float extent, float gauss_denom, int influence, int qpb,
                                       float* __restrict__ weighted, float* __restrict__ nn) {
  extern __shared__ float wsm[];  // [qpb][H][kKMax]
  int* cnt = reinterpret_cast<int*>(wsm + (size_t)qpb * h_count * kKMax);  // [qpb]
  const int n0 = blockIdx.x * qpb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < qpb; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  // One warp per (query, neighbor).
  for (int p = warp; p < qpb * h_count; p += nwarps) {
    const int qi = p / h_count;
    const int h = p - qi * h_count;
    const int nq = n0 + qi;
    float w = 0.0f;
    if (nq < n) {
      const size_t row = (size_t)nq * h_count + h;
      w = pcrcg::lane_influence(rel[3 * row], rel[3 * row + 1], rel[3 * row + 2], kp, k_count,
                                lane, influence, extent, gauss_denom, 0);
      float fs = 0.0f;
      for (int c = lane; c < c_in; c += 32) fs += nx[row * c_in + c];
      for (int off = 16; off > 0; off >>= 1) fs += __shfl_xor_sync(0xffffffffu, fs, off);
      if (lane == 0 && fs > 0.0f) atomicAdd(&cnt[qi], 1);
    }
    if (lane < kKMax) wsm[(qi * h_count + h) * kKMax + lane] = (lane < k_count) ? w : 0.0f;
  }
  __syncthreads();

  // (query, channel) pairs: weighted[k, n, c] = sum_h w[h, k] nx[n, h, c].
  for (int idx = threadIdx.x; idx < qpb * c_in; idx += blockDim.x) {
    const int qi = idx / c_in;
    const int c = idx - qi * c_in;
    const int nq = n0 + qi;
    if (nq >= n) continue;
    float acc[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) acc[k] = 0.0f;
    const float* f = nx + (size_t)nq * h_count * c_in + c;
    for (int h = 0; h < h_count; ++h) {
      const float x = f[(size_t)h * c_in];
      const float* wp = wsm + (qi * h_count + h) * kKMax;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) acc[k] = fmaf(wp[k], x, acc[k]);
    }
    float* out = weighted + (size_t)nq * c_in + c;
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (k < k_count) out[(size_t)k * n * c_in] = acc[k];
    }
  }
  for (int i = threadIdx.x; i < qpb; i += blockDim.x) {
    if (n0 + i < n) nn[n0 + i] = (float)max(cnt[i], 1);
  }
}

}  // namespace

// rel [n, h_count, 3], nx [n, h_count, c_in], kp [k_count, 3] -> weighted
// [k_count, n, c_in] and nn [n].  Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int pcrcg_kpconv_weighted_reduce(const float* rel, const float* nx, int n,
                                            int h_count, int c_in, const float* kp,
                                            int k_count, float extent, float gauss_denom,
                                            int influence, float* weighted, float* nn,
                                            void* stream) {
  if (n <= 0) return 0;
  if (k_count > kKMax || k_count <= 0 || c_in <= 0) return (int)cudaErrorInvalidValue;
  int qpb = kThreads / c_in;
  qpb = qpb < 1 ? 1 : (qpb > 16 ? 16 : qpb);
  auto smem_of = [&](int qb) {
    return (size_t)qb * h_count * kKMax * sizeof(float) + qb * sizeof(int);
  };
  while (qpb > 1 && smem_of(qpb) > 48 * 1024) --qpb;
  const size_t smem = smem_of(qpb);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(weighted_reduce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  weighted_reduce_kernel<<<(n + qpb - 1) / qpb, kThreads, smem, (cudaStream_t)stream>>>(
      rel, nx, n, h_count, c_in, kp, k_count, extent, gauss_denom, influence, qpb, weighted, nn);
  return (int)cudaGetLastError();
}
