// Phase A of the gathered-feature KPConv kernels: the forward of K6 / K7
// (kpconv_fused.cu) and K3's recomputation of `weighted` in its gathered
// backward (kpconv_bwd.cu):
//
//   weighted_t[k * C + c, n] = sum_h w[n, h, k] nx_t[h, c_skip + c, n]
//   nn[n] = max(1, #{h : sum_{c >= c_skip} nx_t[h, c, n] > 0})
//
// for the C = c_total - c_skip feature rows.  The features come gathered in
// the TPU kernels' layout nx_t [H, c_total, N]: for one (neighbor, channel)
// the N queries are contiguous, so lanes sit on queries and every read of
// nx_t (and write of weighted_t [K*C, N]) is coalesced.  Geometry: rel
// [N, H, 3] (K6, K3) or, for the merged gather of K7, rel = nx_t[h, 0:3, n]
// - q[n] from the gathered absolute coordinates (rows 0-2; rows 3-7 are
// zero pad, and c_skip = 8 leaves all eight out of the sums).
//
// What bounds it on the H100: the bytes of nx_t (545 MB at level 0 for the
// (64, 64) conv: 0.16 ms at 3.35 TB/s) and of weighted_t (204 MB there);
// its 2 N H K C multiply-adds take a third of that time at 67 TFLOP/s.
// Two kernels:
// - C > 4 (gathered_reduce_wide_kernel): a block takes 16 queries.  It
//   copies their rel (one contiguous 16 x H x 3 block) into shared memory
//   with consecutive threads on consecutive addresses, computes every
//   (query, neighbor) influence once into [H][4][16] float4s (H KB), then
//   walks the channels in groups of 64: a thread owns 4 channels of one
//   query (lanes: 16 queries x 2 channel quads) with 4 x 16 accumulators,
//   so each 16-byte influence read serves 16 multiply-adds, and there is
//   no barrier inside the walk.  The same feature reads give the neighbor
//   sums: each thread adds its 4 channels, group after group, into its own
//   shared-memory slot, and the slots are added in a fixed order at the
//   end -- one pass over nx_t, no floating-point atomics.  ~2 KB of shared
//   memory a neighbor (83 KB at H = 40) and 128 registers leave two blocks
//   an SM.  Where 16-query blocks cannot fill the card (N = 1,536 at level
//   3), the channel groups are also split over a grid dimension (the
//   planner ops/kpconv_fused.py::phase_a_split), and each split's sums go
//   to nn_part for count_neighbors_kernel, which adds them in order.
//   What holds it: its reads run 64 bytes a row a block, short of the
//   rate of a long contiguous sweep, and the influences and the
//   multiply-adds do not hide behind them.  Tried and not kept (no faster
//   in a side-by-side run on the card): a cp.async ring of 3 x 16 KB
//   feature stages, 32-query blocks, deeper or shallower unrolling.
// - C <= 4 (gathered_reduce_narrow_kernel; block 0's ones column, C = 1):
//   4 adjacent lanes per query, each taking every fourth neighbor with
//   its influences in registers, their partial sums added in lane order by
//   shuffles; no shared memory beyond the kernel points.  The influences
//   (~40 instructions a kernel point) bound it.
// The wide kernel's `weighted` entries are each one fmaf chain over h in
// order, as in the kernel this replaces (the same weighted_t bit for bit);
// the narrow kernel's are four such chains added in a fixed order.
#pragma once

#include <cuda_runtime.h>

#include "kpconv_common.cuh"

namespace pcrcg {

constexpr int kWideTileQ = 16;        // queries a block of the wide kernel
constexpr int kQuads = 16;            // channel quads a block holds (2 a warp)
constexpr int kGroupC = 4 * kQuads;   // channels a group
constexpr int kPhaseAThreads = kWideTileQ * kQuads;  // 8 warps, the wide kernel
constexpr int kWideBlocksPerSm = 2;
constexpr int kReduceUnroll = 4;      // neighbors a reduce step loads ahead
constexpr int kNarrowC = 4;           // C up to this: the narrow kernel
constexpr int kNarrowThreads = 128;
constexpr int kNarrowLanes = 4;       // lanes a query of the narrow kernel
constexpr int kNarrowMinBlocks = 4;   // resident blocks an SM at C = 1: at most 128 registers

// Floats of one quad's neighbor sums, [H][kWideTileQ] padded so the two half
// warps (adjacent quads, the same queries) fall in other banks.
__host__ __device__ inline int sum_pitch(int h_count) { return h_count * kWideTileQ + 16; }

inline size_t wide_smem_bytes(int h_count) {
  return (size_t)h_count * 4 * kWideTileQ * sizeof(float4) +
         (size_t)kQuads * sum_pitch(h_count) * sizeof(float) + kWideTileQ * sizeof(int) +
         3 * kKMax * sizeof(float);
}

__device__ __forceinline__ void load_kps(const float* __restrict__ kp, int k_count, float* kps,
                                         int tid, int threads) {
  for (int i = tid; i < 3 * kKMax; i += threads) kps[i] = i < 3 * k_count ? kp[i] : 0.0f;
}

// C > 4.  Grid: (ceil(n / 16), split); block y walks the channel groups
// [y gpb, min(groups, (y + 1) gpb)).  nn null: no count.  split > 1 with nn:
// the block's neighbor sums go to nn_part [split, H, N].
__global__ void __launch_bounds__(kPhaseAThreads, kWideBlocksPerSm)
    gathered_reduce_wide_kernel(const float* __restrict__ rel, const float* __restrict__ q,
                                const float* __restrict__ nx_t, int n, int h_count,
                                int c_total, int c_skip, const float* __restrict__ kp,
                                int k_count, float extent, float gauss_denom, int influence,
                                int closest, int gpb, float* __restrict__ weighted_t,
                                float* __restrict__ nn, float* __restrict__ nn_part) {
  extern __shared__ __align__(16) float smem[];
  float4* sw = reinterpret_cast<float4*>(smem);  // [H][kKMax / 4][kWideTileQ]
  float* fsum = smem + (size_t)h_count * 4 * kWideTileQ * 4;  // [kQuads][sum_pitch]
  int* cnt = reinterpret_cast<int*>(fsum + kQuads * sum_pitch(h_count));
  float* kps = reinterpret_cast<float*>(cnt + kWideTileQ);
  float* srel = fsum;  // rel of the tile, [16][H][3], until the sums need the room

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kWideTileQ;
  const int c_feat = c_total - c_skip;
  const int groups = (c_feat + kGroupC - 1) / kGroupC;
  const int g_begin = blockIdx.y * gpb;
  const int g_end = min(groups, g_begin + gpb);
  const bool count = nn != nullptr;
  const bool partial = gridDim.y > 1;
  const int spitch = sum_pitch(h_count);

  load_kps(kp, k_count, kps, tid, kPhaseAThreads);
  if (tid < kWideTileQ) cnt[tid] = 0;
  if (rel != nullptr) {
    const float* src = rel + (size_t)n0 * h_count * 3;
    const int avail = (min(n, n0 + kWideTileQ) - n0) * h_count * 3;
    for (int i = tid; i < kWideTileQ * h_count * 3; i += kPhaseAThreads)
      srel[i] = i < avail ? src[i] : 0.0f;
  }
  __syncthreads();

  // Every (query, neighbor) influence of the tile, once.
  for (int p = tid; p < kWideTileQ * h_count; p += kPhaseAThreads) {
    const int qi = p % kWideTileQ, h = p / kWideTileQ;
    const int nq = n0 + qi;
    float w[kKMax];
    if (nq < n) {
      float rx, ry, rz;
      if (rel != nullptr) {
        const float* r = srel + (qi * h_count + h) * 3;
        rx = r[0];
        ry = r[1];
        rz = r[2];
      } else {
        const float* r = nx_t + (size_t)h * c_total * n + nq;
        rx = __fsub_rn(r[0], q[3 * (size_t)nq]);
        ry = __fsub_rn(r[n], q[3 * (size_t)nq + 1]);
        rz = __fsub_rn(r[2 * (size_t)n], q[3 * (size_t)nq + 2]);
      }
      point_influences(rx, ry, rz, kps, k_count, influence, extent, gauss_denom, closest, w);
    } else {
#pragma unroll
      for (int k = 0; k < kKMax; ++k) w[k] = 0.0f;
    }
#pragma unroll
    for (int k4 = 0; k4 < kKMax / 4; ++k4)
      sw[(h * 4 + k4) * kWideTileQ + qi] =
          make_float4(w[4 * k4], w[4 * k4 + 1], w[4 * k4 + 2], w[4 * k4 + 3]);
  }
  __syncthreads();

  // The channel walk: query qa, channels c0 .. c0 + 3 of each group.
  const int qa = tid % kWideTileQ;
  const int quad = tid / kWideTileQ;
  const int na = n0 + qa;
  float* my_sum = fsum + quad * spitch + qa;
  for (int g = g_begin; g < g_end; ++g) {
    const int c0 = g * kGroupC + quad * 4;
    if (c0 >= c_feat) break;
    float acc[kKMax][4];
#pragma unroll
    for (int k = 0; k < kKMax; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;
    const float* f_base = nx_t + (size_t)(c_skip + c0) * n + na;
    const size_t h_stride = (size_t)c_total * n;
#pragma unroll kReduceUnroll
    for (int h = 0; h < h_count; ++h) {
      float f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f[c] = (na < n && c0 + c < c_feat) ? f_base[h * h_stride + (size_t)c * n] : 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < kKMax / 4; ++k4) {
        const float4 w4 = sw[(h * 4 + k4) * kWideTileQ + qa];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[4 * k4][c] = fmaf(w4.x, f[c], acc[4 * k4][c]);
          acc[4 * k4 + 1][c] = fmaf(w4.y, f[c], acc[4 * k4 + 1][c]);
          acc[4 * k4 + 2][c] = fmaf(w4.z, f[c], acc[4 * k4 + 2][c]);
          acc[4 * k4 + 3][c] = fmaf(w4.w, f[c], acc[4 * k4 + 3][c]);
        }
      }
      if (count) {
        const float s = ((f[0] + f[1]) + f[2]) + f[3];
        my_sum[h * kWideTileQ] = g == g_begin ? s : my_sum[h * kWideTileQ] + s;
      }
    }
    if (na < n) {
#pragma unroll
      for (int k = 0; k < kKMax; ++k) {
        if (k >= k_count) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c0 + c < c_feat) weighted_t[((size_t)k * c_feat + c0 + c) * n + na] = acc[k][c];
        }
      }
    }
  }
  if (!count) return;

  // Each neighbor's sum over the block's quads, in order.
  __syncthreads();
  const int quads_used = min(kQuads, (c_feat - g_begin * kGroupC + 3) / 4);
  for (int p = tid; p < kWideTileQ * h_count; p += kPhaseAThreads) {
    const int qi = p % kWideTileQ, h = p / kWideTileQ;
    if (n0 + qi >= n) continue;
    float s = fsum[h * kWideTileQ + qi];
    for (int u = 1; u < quads_used; ++u) s += fsum[u * spitch + h * kWideTileQ + qi];
    if (partial)
      nn_part[((size_t)blockIdx.y * h_count + h) * n + n0 + qi] = s;
    else if (s > 0.0f)
      atomicAdd(&cnt[qi], 1);
  }
  if (partial) return;
  __syncthreads();
  if (tid < kWideTileQ && n0 + tid < n) nn[n0 + tid] = (float)max(cnt[tid], 1);
}

// C <= 4 (CC = C): kNarrowLanes adjacent lanes per query, lane j taking
// the neighbors h = j, j + kNarrowLanes, ...; their partial sums are added
// in lane order by shuffles.
template <int CC>
__global__ void __launch_bounds__(kNarrowThreads, CC == 1 ? kNarrowMinBlocks : 1)
    gathered_reduce_narrow_kernel(const float* __restrict__ rel, const float* __restrict__ q,
                                  const float* __restrict__ nx_t, int n, int h_count,
                                  int c_total, int c_skip, const float* __restrict__ kp,
                                  int k_count, float extent, float gauss_denom, int influence,
                                  int closest, float* __restrict__ weighted_t,
                                  float* __restrict__ nn) {
  __shared__ float kps[3 * kKMax];
  load_kps(kp, k_count, kps, threadIdx.x, kNarrowThreads);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int part = lane % kNarrowLanes;
  const int nq = (blockIdx.x * kNarrowThreads + threadIdx.x) / kNarrowLanes;
  const bool live = nq < n;  // every lane stays for the shuffles
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (rel == nullptr && live) {
    qx = q[3 * (size_t)nq];
    qy = q[3 * (size_t)nq + 1];
    qz = q[3 * (size_t)nq + 2];
  }
  float acc[kKMax][CC];
#pragma unroll
  for (int k = 0; k < kKMax; ++k)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[k][c] = 0.0f;
  int cnt = 0;
  for (int h = part; live && h < h_count; h += kNarrowLanes) {
    const float* col = nx_t + (size_t)h * c_total * n + nq;
    float f[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) f[c] = col[(size_t)(c_skip + c) * n];
    float rx, ry, rz;
    if (rel != nullptr) {
      const float* r = rel + ((size_t)nq * h_count + h) * 3;
      rx = r[0];
      ry = r[1];
      rz = r[2];
    } else {
      rx = __fsub_rn(col[0], qx);
      ry = __fsub_rn(col[n], qy);
      rz = __fsub_rn(col[2 * (size_t)n], qz);
    }
    float w[kKMax];
    point_influences(rx, ry, rz, kps, k_count, influence, extent, gauss_denom, closest, w);
#pragma unroll
    for (int k = 0; k < kKMax; ++k)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[k][c] = fmaf(w[k], f[c], acc[k][c]);
    if (nn != nullptr) {
      float s = f[0];
#pragma unroll
      for (int c = 1; c < CC; ++c) s += f[c];
      cnt += s > 0.0f;
    }
  }
  const int base = lane - part;
#pragma unroll
  for (int k = 0; k < kKMax; ++k) {
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      float s = __shfl_sync(0xffffffffu, acc[k][c], base);
#pragma unroll
      for (int j = 1; j < kNarrowLanes; ++j) s += __shfl_sync(0xffffffffu, acc[k][c], base + j);
      if (part == 0 && live && k < k_count) weighted_t[((size_t)k * CC + c) * n + nq] = s;
    }
  }
  if (nn != nullptr) {
    int total = 0;
#pragma unroll
    for (int j = 0; j < kNarrowLanes; ++j) total += __shfl_sync(0xffffffffu, cnt, base + j);
    if (part == 0 && live) nn[nq] = (float)max(total, 1);
  }
}

// nn[n] = max(1, #{h : sum over the splits b = 0, 1, ... in order of
// part[b, h, n] > 0}).
__global__ void count_neighbors_kernel(const float* __restrict__ part, int splits, int h_count,
                                       int n, float* __restrict__ nn) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    int c = 0;
    for (int h = 0; h < h_count; ++h) {
      float s = part[(size_t)h * n + i];
      for (int b = 1; b < splits; ++b) s += part[((size_t)b * h_count + h) * n + i];
      c += s > 0.0f;
    }
    nn[i] = (float)max(c, 1);
  }
}

// Phase A on `st`: weighted_t [k_count * (c_total - c_skip), n] and, when nn
// is not null, nn [n].  `split`: the channel-group split of the wide kernel
// (ops/kpconv_fused.py::phase_a_split; 1 for C <= 4); nn_part [split,
// h_count, n] is scratch for the counts when split > 1 and nn is not null.
// Returns a CUDA error code.
inline cudaError_t launch_gathered_reduce(const float* rel, const float* q, const float* nx_t,
                                          int n, int h_count, int c_total, int c_skip,
                                          const float* kp, int k_count, float extent,
                                          float gauss_denom, int influence, int closest,
                                          int split, float* weighted_t, float* nn,
                                          float* nn_part, cudaStream_t st) {
  const int c_feat = c_total - c_skip;
  if (n <= 0) return cudaSuccess;
  if (c_feat <= 0 || h_count <= 0 || k_count <= 0 || k_count > kKMax ||
      (rel == nullptr) == (q == nullptr) || split < 1)
    return cudaErrorInvalidValue;
  if (c_feat <= kNarrowC) {
    if (split != 1) return cudaErrorInvalidValue;
    auto kernel = c_feat == 1   ? gathered_reduce_narrow_kernel<1>
                  : c_feat == 2 ? gathered_reduce_narrow_kernel<2>
                  : c_feat == 3 ? gathered_reduce_narrow_kernel<3>
                                : gathered_reduce_narrow_kernel<4>;
    const long long threads = (long long)n * kNarrowLanes;
    kernel<<<(unsigned)((threads + kNarrowThreads - 1) / kNarrowThreads), kNarrowThreads, 0,
             st>>>(rel, q, nx_t, n, h_count, c_total, c_skip, kp, k_count, extent, gauss_denom,
                   influence, closest, weighted_t, nn);
    return cudaGetLastError();
  }
  const int groups = (c_feat + kGroupC - 1) / kGroupC;
  const int gpb = (groups + split - 1) / split;
  if (split > groups || (split - 1) * gpb >= groups) return cudaErrorInvalidValue;
  if (nn != nullptr && split > 1 && nn_part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = wide_smem_bytes(h_count);
  // Set on every launch (a static flag in a shared header would be one
  // object across the libraries that include it).
  cudaError_t e = cudaFuncSetAttribute(gathered_reduce_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kWideTileQ - 1) / kWideTileQ, split);
  gathered_reduce_wide_kernel<<<grid, kPhaseAThreads, smem, st>>>(
      rel, q, nx_t, n, h_count, c_total, c_skip, kp, k_count, extent, gauss_denom, influence,
      closest, gpb, weighted_t, nn, nn_part);
  e = cudaGetLastError();
  if (e != cudaSuccess || nn == nullptr || split == 1) return e;
  count_neighbors_kernel<<<(n + 255) / 256, 256, 0, st>>>(nn_part, split, h_count, n, nn);
  return cudaGetLastError();
}

}  // namespace pcrcg
