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
// What bounds it on the H100: bytes.  It must read nx once (545 MB for a
// level-0 (64, 64) conv: 0.16 ms at 3.35 TB/s) and write weighted, K = 15
// times the size of one [N, C] output (204 MB at level 0); its operations
// (2 K per nx element) take about a third of that time at 67 TFLOP/s.
//
// The design is the phase A of K6 (kpconv_gathered.cuh) turned to this
// layout, where a (query, neighbor) row of C channels is contiguous:
// - A block takes tq queries; tpq = 256 / tq threads share a query (a power
//   of two, at least 16, so a query's threads never straddle a warp unless
//   they fill whole warps).  Each thread owns 4 consecutive channels (a
//   quad) x the K kernel points: 64 accumulators, so each 16-byte influence
//   read from shared memory serves 16 multiply-adds.
// - The block's tq x H influences are computed first, one thread a
//   (query, neighbor) with every lane busy, and stay in shared memory.
// - nx is read once, as float4 where C % 4 == 0 (a scalar tail otherwise,
//   C = 1 included), and weighted is written as float4 [K, N, C] rows.
// - The counts come from the same reads: each thread adds its 4 channels
//   into its own shared-memory slot a neighbor, and at the end the slots of
//   a query are added in thread order.  No floating-point atomics:
//   weighted and nn are run-to-run bit-identical.  Each weighted entry is
//   one fmaf chain over h in order, as in the kernel this replaces.
// 62-83 KB of shared memory (H = 40) and 127 registers leave two blocks an
// SM.  Measured side by side on one H100 over the 10 full-width calls
// (kernel_variants.py): 1.395 ms; the counts' sums added across the
// query's lanes by a shuffle butterfly inside the walk instead 2.244;
// loading 2 neighbors ahead 1.668, 4 ahead 1.423.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kpconv_common.cuh"

namespace {

using pcrcg::kKMax;
constexpr int kThreads = 256;
constexpr int kMinTpq = 16;   // threads a query, at least
constexpr int kUnroll = 8;    // neighbors a step loads ahead
constexpr int kMaxSmem = 232448;

// A thread's neighbor-sum slots: H rounded up to odd, so the threads'
// slots of one neighbor fall in distinct banks.
__host__ __device__ inline int slot_pitch(int h_count) { return h_count | 1; }

// Shared memory: influences [tq][H][kKMax / 4] float4, the neighbor sums'
// slots [kThreads][slot_pitch], counts [tq], kernel points [3 kKMax].
size_t smem_bytes(int tq, int h_count) {
  return (size_t)tq * h_count * kKMax * sizeof(float) +
         (size_t)kThreads * slot_pitch(h_count) * sizeof(float) + tq * sizeof(int) +
         3 * kKMax * sizeof(float);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    weighted_reduce_kernel(const float* __restrict__ rel, const float* __restrict__ nx, int n,
                           int h_count, int c_in, const float* __restrict__ kp, int k_count,
                           float extent, float gauss_denom, int influence, int tpq,
                           float* __restrict__ weighted, float* __restrict__ nn) {
  extern __shared__ __align__(16) float smem[];
  const int tq = kThreads / tpq;
  const int pitch = slot_pitch(h_count);
  float4* sw = reinterpret_cast<float4*>(smem);
  float* slots = smem + (size_t)tq * h_count * kKMax;
  int* cnt = reinterpret_cast<int*>(slots + (size_t)kThreads * pitch);
  float* kps = reinterpret_cast<float*>(cnt + tq);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * tq;
  for (int i = tid; i < 3 * kKMax; i += kThreads) kps[i] = i < 3 * k_count ? kp[i] : 0.0f;
  if (tid < tq) cnt[tid] = 0;
  __syncthreads();

  // Every (query, neighbor) influence of the block, once.
  for (int p = tid; p < tq * h_count; p += kThreads) {
    const int nq = n0 + p / h_count;
    float w[kKMax];
    if (nq < n) {
      const float* r = rel + ((size_t)n0 * h_count + p) * 3;
      pcrcg::point_influences(r[0], r[1], r[2], kps, k_count, influence, extent, gauss_denom,
                              0, w);
    } else {
#pragma unroll
      for (int k = 0; k < kKMax; ++k) w[k] = 0.0f;
    }
#pragma unroll
    for (int k4 = 0; k4 < kKMax / 4; ++k4)
      sw[p * 4 + k4] = make_float4(w[4 * k4], w[4 * k4 + 1], w[4 * k4 + 2], w[4 * k4 + 3]);
  }
  __syncthreads();

  // The channel walk: query qa, quads lq, lq + tpq, ... of its channels.
  const int qa = tid / tpq;
  const int lq = tid - qa * tpq;
  const int na = n0 + qa;
  const bool live = na < n;
  const int quads = (c_in + 3) / 4;
  const int passes = (quads + tpq - 1) / tpq;
  const float4* wq = sw + (size_t)qa * h_count * 4;
  float* my_slots = slots + (size_t)tid * pitch;
  const float* row0 = nx + (size_t)(live ? na : 0) * h_count * c_in;
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = 4 * (lq + pass * tpq);
    const bool act = live && c0 < c_in;
    float acc[kKMax][4];
#pragma unroll
    for (int k = 0; k < kKMax; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;
#pragma unroll kUnroll
    for (int h = 0; h < h_count; ++h) {
      float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* src = row0 + (size_t)h * c_in + c0;
      if (kVec) {
        if (act) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          f[0] = v.x;
          f[1] = v.y;
          f[2] = v.z;
          f[3] = v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (act && c0 + c < c_in) f[c] = src[c];
      }
#pragma unroll
      for (int k4 = 0; k4 < kKMax / 4; ++k4) {
        const float4 w4 = wq[h * 4 + k4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[4 * k4][c] = fmaf(w4.x, f[c], acc[4 * k4][c]);
          acc[4 * k4 + 1][c] = fmaf(w4.y, f[c], acc[4 * k4 + 1][c]);
          acc[4 * k4 + 2][c] = fmaf(w4.z, f[c], acc[4 * k4 + 2][c]);
          acc[4 * k4 + 3][c] = fmaf(w4.w, f[c], acc[4 * k4 + 3][c]);
        }
      }
      const float s = ((f[0] + f[1]) + f[2]) + f[3];
      my_slots[h] = pass == 0 ? s : my_slots[h] + s;
    }
    if (act) {
#pragma unroll
      for (int k = 0; k < kKMax; ++k) {
        if (k >= k_count) break;
        float* dst = weighted + ((size_t)k * n + na) * c_in + c0;
        if (kVec) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < c_in) dst[c] = acc[k][c];
        }
      }
    }
  }

  // Each neighbor's sum over the query's threads, in order.
  __syncthreads();
  for (int p = tid; p < tq * h_count; p += kThreads) {
    const int qi = p / h_count, h = p - qi * h_count;
    if (n0 + qi >= n) continue;
    const float* qs = slots + (size_t)qi * tpq * pitch + h;
    float s = qs[0];
    for (int u = 1; u < tpq; ++u) s += qs[(size_t)u * pitch];
    if (s > 0.0f) atomicAdd(&cnt[qi], 1);
  }
  __syncthreads();
  if (tid < tq && n0 + tid < n) nn[n0 + tid] = (float)max(cnt[tid], 1);
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
  if (k_count > kKMax || k_count <= 0 || c_in <= 0 || h_count <= 0)
    return (int)cudaErrorInvalidValue;
  const int quads = (c_in + 3) / 4;
  int tpq = kMinTpq;
  while (tpq < quads && tpq < kThreads) tpq *= 2;
  const int tq = kThreads / tpq;
  const size_t smem = smem_bytes(tq, h_count);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = c_in % 4 == 0 && ((uintptr_t)nx & 15) == 0 && ((uintptr_t)weighted & 15) == 0;
  auto kernel = vec ? weighted_reduce_kernel<true> : weighted_reduce_kernel<false>;
  // Set on every launch (see kpconv_gathered.cuh).
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(n + tq - 1) / tq, kThreads, smem, (cudaStream_t)stream>>>(
      rel, nx, n, h_count, c_in, kp, k_count, extent, gauss_denom, influence, tpq, weighted, nn);
  return (int)cudaGetLastError();
}
