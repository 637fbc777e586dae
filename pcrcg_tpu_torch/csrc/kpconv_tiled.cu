// Candidate-tile KPConv forward (K2).
//
// Replaces the Pallas TPU kernel pcrcg_tpu/ops/kpconv_tiled.py::_build_kernel
// (wrapper kpconv_tiled), forward only, without the residual outputs.
//
// The TPU kernel DMA'd each 128-query group's M candidate tiles into VMEM and
// gathered neighbor rows with one-hot MXU matmuls, packing coordinates and
// features into bf16 hi/lo limbs, because row gathers are latency-bound on a
// TPU.  None of that carries over: one group's candidate block (1,536 rows of
// 3 + C floats) does not fit a Hopper block's 227 KB of shared memory at
// C >= 32, and a GPU gathers rows natively.  So the kernel resolves each
// neighbor to its global support row (tiles[g][lidx / tile] * tile +
// lidx % tile) and reads it straight from global memory / L2, in fp32.
//
// Phase A (kpconv_reduce_kernel): a block takes `qpb` queries.  One warp per
// (query, neighbor) resolves the row, computes rel = s - q (shadow: -q), the
// K influence weights (lane k = kernel point k, closest aggregation by a warp
// min), and the neighbor's feature sum for nn (warp-reduced, > 0 counts).
// Then the threads walk (query, channel) pairs with coalesced feature reads
// and K accumulators each, writing weighted[n, k, c] = sum_h w[h,k] f[h,c]
// to an fp32 scratch of Nq x K*C.
//
// Phase B (sgemm_kernel of sgemm.cuh): a shared-memory-tiled fp32 GEMM,
// out[Nq, D] = weighted[Nq, K*C] x W[K*C, D], 64 x 64 tiles, 4 x 4 outputs a
// thread.  The W contraction is part of the TPU kernel's body, so it is
// written here and not left to a library.  `weighted` is kept for the
// backward (K3's dW) when the caller trains, else it is scratch.
//
// What bounds it on the H100: at the wide levels (C, D >= 128) the GEMM's
// operations (2 Nq K C D: 12 GFLOP for the level-3 512 x 512 convs, 0.18 ms
// at 67 TFLOP/s fp32); at level 0 the bytes of the scratch round trip and
// the H x C feature gathers.  This first version keeps every operand in fp32
// on the CUDA cores; wgmma/TF32 tiles and fusing phase B into phase A (to
// drop the scratch) are later work.
#include <cuda_runtime.h>
#include <math.h>

#include "kpconv_common.cuh"
#include "sgemm.cuh"

namespace {

using pcrcg::kKMax;
constexpr int kThreads = 256;

__global__ void kpconv_reduce_kernel(
    const float* __restrict__ q, int nq, const float* __restrict__ s, int ns,
    const float* __restrict__ feats, int c_in, const int* __restrict__ lidx, int h_count,
    const int* __restrict__ tiles, int m_tiles, int tile, const float* __restrict__ kp,
    int k_count, float extent, float gauss_denom, int influence, int closest, int qpb,
    float* __restrict__ weighted, float* __restrict__ nn) {
  extern __shared__ float smem[];
  float* wsm = smem;                                     // [qpb][H][kKMax]
  int* rows = reinterpret_cast<int*>(wsm + qpb * h_count * kKMax);  // [qpb][H]
  int* cnt = rows + qpb * h_count;                       // [qpb]
  const int n0 = blockIdx.x * qpb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < qpb; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  // Phase A1: one warp per (query, neighbor).
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
      float fs = 0.0f;
      if (row >= 0) {
        for (int c = lane; c < c_in; c += 32) fs += feats[(size_t)row * c_in + c];
      }
      for (int off = 16; off > 0; off >>= 1) fs += __shfl_xor_sync(0xffffffffu, fs, off);
      if (lane == 0 && fs > 0.0f) atomicAdd(&cnt[qi], 1);
    }
    if (lane < kKMax) wsm[(qi * h_count + h) * kKMax + lane] = (lane < k_count) ? w : 0.0f;
    if (lane == 0) rows[qi * h_count + h] = row;
  }
  __syncthreads();

  // Phase A2: weighted[n, k, c] over (query, channel) pairs.
  for (int idx = threadIdx.x; idx < qpb * c_in; idx += blockDim.x) {
    const int qi = idx / c_in;
    const int c = idx - qi * c_in;
    const int n = n0 + qi;
    if (n >= nq) continue;
    float acc[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) acc[k] = 0.0f;
    for (int h = 0; h < h_count; ++h) {
      const int row = rows[qi * h_count + h];
      if (row < 0) continue;
      const float f = feats[(size_t)row * c_in + c];
      const float* wp = wsm + (qi * h_count + h) * kKMax;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) acc[k] = fmaf(wp[k], f, acc[k]);
    }
    float* out = weighted + (size_t)n * k_count * c_in + c;
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (k < k_count) out[(size_t)k * c_in] = acc[k];
    }
  }
  for (int i = threadIdx.x; i < qpb; i += blockDim.x) {
    if (n0 + i < nq) nn[n0 + i] = (float)max(cnt[i], 1);
  }
}

}  // namespace

// q [nq, 3], s [ns, 3], feats [ns, c_in], lidx [>= nq, h_count] int32,
// tiles [groups, m_tiles] int32, kp [k_count, 3], W [k_count * c_in, d];
// weighted [nq, k_count * c_in] (phase A's output); out [nq, d] (before the
// division by nn) and nn [nq].  Returns cudaGetLastError() after both
// launches on `stream`.
extern "C" int pcrcg_kpconv_tiled(const float* q, int nq, const float* s, int ns,
                                  const float* feats, int c_in, const int* lidx,
                                  int h_count, const int* tiles, int m_tiles, int tile,
                                  const float* kp, int k_count, const float* W, int d,
                                  float extent, float gauss_denom, int influence,
                                  int closest, float* weighted, float* out, float* nn,
                                  void* stream) {
  if (nq <= 0) return 0;
  if (k_count > kKMax || k_count <= 0) return (int)cudaErrorInvalidValue;
  int qpb = kThreads / (c_in > 0 ? c_in : 1);
  qpb = qpb < 1 ? 1 : (qpb > 16 ? 16 : qpb);
  auto smem_of = [&](int qb) {
    return (size_t)qb * h_count * (kKMax * sizeof(float) + sizeof(int)) + qb * sizeof(int);
  };
  while (qpb > 1 && smem_of(qpb) > 48 * 1024) --qpb;
  const size_t smem = smem_of(qpb);
  cudaStream_t st = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kpconv_reduce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kpconv_reduce_kernel<<<(nq + qpb - 1) / qpb, kThreads, smem, st>>>(
      q, nq, s, ns, feats, c_in, lidx, h_count, tiles, m_tiles, tile, kp, k_count, extent,
      gauss_denom, influence, closest, qpb, weighted, nn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)pcrcg::launch_sgemm<false, false>(nq, d, k_count * c_in, k_count * c_in,
                                                 weighted, W, out, st);
}
