// Device code shared by the gathered-feature KPConv kernels: the forward of
// K6 / K7 (kpconv_fused.cu) and K3's gathered backward (kpconv_bwd.cu).
//
// Their features come gathered in the TPU kernels' layout nx_t [H, C, N]:
// for one (neighbor, channel) the N queries are contiguous.  So a block
// takes a tile of kTileQ = 32 consecutive queries, one per lane, and every
// loop that reads nx_t (or writes a [., N] array) has the lanes on queries:
// each warp access is one coalesced 128-byte line.  The warps split the
// channels.  `weighted` is written transposed, weighted_t [K*C, N], for the
// same reason; the GEMMs of sgemm.cuh take it as a transposed operand.
//
// Geometry: either rel [N, H, 3] (K6, K3) or, for the merged gather of K7,
// rel = nx_t[h, 0:3, n] - q[n] from the gathered absolute coordinates
// (channel rows 0-2; rows 3-7 are zero pad, features from row 8).
#pragma once

#include <cuda_runtime.h>

#include "kpconv_common.cuh"

namespace pcrcg {

constexpr int kTileQ = 32;             // queries per block, one per lane
constexpr int kGatheredThreads = 256;  // 8 warps split the channels

// Shared memory of a gathered kernel: the tile's influences [H][kKMax][kTileQ]
// and a neighbor count per query.
inline size_t gathered_smem_bytes(int h_count) {
  return (size_t)h_count * kKMax * kTileQ * sizeof(float) + kTileQ * sizeof(int);
}

// Influences of the kernel points on every (neighbor, query) of the tile
// starting at query n0 into wsm[(h * kKMax + k) * kTileQ + qi] (zero past
// k_count and for queries past n).  One thread per (neighbor, query), the
// query fastest.
__device__ __forceinline__ void tile_influences(
    float* wsm, const float* __restrict__ rel, const float* __restrict__ q,
    const float* __restrict__ nx_t, int n, int h_count, int c_total, int n0,
    const float* __restrict__ kp, int k_count, int influence, float extent,
    float gauss_denom, int closest) {
  for (int p = threadIdx.x; p < h_count * kTileQ; p += blockDim.x) {
    const int qi = p % kTileQ;
    const int h = p / kTileQ;
    const int nq = n0 + qi;
    float w[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) w[k] = 0.0f;
    if (nq < n) {
      float rx, ry, rz;
      if (rel != nullptr) {
        const float* r = rel + ((size_t)nq * h_count + h) * 3;
        rx = r[0];
        ry = r[1];
        rz = r[2];
      } else {
        const float* r = nx_t + (size_t)h * c_total * n + nq;
        rx = __fsub_rn(r[0], q[3 * (size_t)nq]);
        ry = __fsub_rn(r[n], q[3 * (size_t)nq + 1]);
        rz = __fsub_rn(r[2 * (size_t)n], q[3 * (size_t)nq + 2]);
      }
      point_influences(rx, ry, rz, kp, k_count, influence, extent, gauss_denom, closest, w);
    }
#pragma unroll
    for (int k = 0; k < kKMax; ++k) wsm[(h * kKMax + k) * kTileQ + qi] = w[k];
  }
}

// Phase A of K6 / K7, and K3's recomputation of it:
//   weighted_t[k * C + c, n] = sum_h w[n, h, k] nx_t[h, c, n]
// over every channel row c < c_total, and, when nn is not null,
//   nn[n] = max(1, #{h : sum_{c >= c_skip} nx_t[h, c, n] > 0}).
// Grid: ceil(n / kTileQ) blocks of kGatheredThreads, gathered_smem_bytes.
__global__ void gathered_reduce_kernel(
    const float* __restrict__ rel, const float* __restrict__ q,
    const float* __restrict__ nx_t, int n, int h_count, int c_total, int c_skip,
    const float* __restrict__ kp, int k_count, float extent, float gauss_denom,
    int influence, int closest, float* __restrict__ weighted_t, float* __restrict__ nn) {
  extern __shared__ float wsm[];
  int* cnt = reinterpret_cast<int*>(wsm + (size_t)h_count * kKMax * kTileQ);
  const int n0 = blockIdx.x * kTileQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nq = n0 + lane;
  const bool live = nq < n;
  if (threadIdx.x < kTileQ) cnt[threadIdx.x] = 0;
  tile_influences(wsm, rel, q, nx_t, n, h_count, c_total, n0, kp, k_count, influence, extent,
                  gauss_denom, closest);
  __syncthreads();

  if (nn != nullptr) {
    // Each neighbor's feature sum, a warp per neighbor, lanes on queries.
    for (int h = warp; h < h_count; h += nwarps) {
      if (!live) continue;
      const float* f = nx_t + ((size_t)h * c_total + c_skip) * n + nq;
      float fs = 0.0f;
      for (int c = c_skip; c < c_total; ++c, f += n) fs += *f;
      if (fs > 0.0f) atomicAdd(&cnt[lane], 1);
    }
  }

  for (int c = warp; c < c_total; c += nwarps) {
    if (!live) continue;
    float acc[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) acc[k] = 0.0f;
    const float* f = nx_t + (size_t)c * n + nq;
    const size_t h_stride = (size_t)c_total * n;
    for (int h = 0; h < h_count; ++h) {
      const float x = f[h * h_stride];
      const float* wp = wsm + h * kKMax * kTileQ + lane;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) acc[k] = fmaf(wp[k * kTileQ], x, acc[k]);
    }
    float* out = weighted_t + (size_t)c * n + nq;
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (k < k_count) out[(size_t)k * c_total * n] = acc[k];
    }
  }

  if (nn != nullptr) {
    __syncthreads();
    if (threadIdx.x < kTileQ && n0 + (int)threadIdx.x < n) {
      nn[n0 + threadIdx.x] = (float)max(cnt[threadIdx.x], 1);
    }
  }
}

// Launch gathered_reduce_kernel on `st` (raising its dynamic shared memory
// limit when the tile's influences need more than 48 KB).
inline cudaError_t launch_gathered_reduce(const float* rel, const float* q, const float* nx_t,
                                          int n, int h_count, int c_total, int c_skip,
                                          const float* kp, int k_count, float extent,
                                          float gauss_denom, int influence, int closest,
                                          float* weighted_t, float* nn, cudaStream_t st) {
  const size_t smem = gathered_smem_bytes(h_count);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gathered_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  gathered_reduce_kernel<<<(n + kTileQ - 1) / kTileQ, kGatheredThreads, smem, st>>>(
      rel, q, nx_t, n, h_count, c_total, c_skip, kp, k_count, extent, gauss_denom, influence,
      closest, weighted_t, nn);
  return cudaGetLastError();
}

}  // namespace pcrcg
