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
// Two launches, each its own C entry (the wrapper calls both):
//
// Phase A (pcrcg_kpconv_tiled_reduce) writes weighted[n, k, c] =
// sum_h w[h, k] f[row(n, h), c] (fp32, Nq x K*C, kept for the backward's
// dW when the caller trains) and nn[n].  Every neighbor's dependent reads
// (lidx -> tiles -> support row) are latency-bound, so each (query,
// neighbor) pair gets its own thread (A1: the row and the K influences,
// point_influences, bit for bit lane_influence's arithmetic, into shared
// memory), and a block takes `qpb` queries, sized from its 256 threads and
// a shared-memory budget so that both A1's pairs and A2's items fill it.
// (Sizing it as min(16, 256 / C) left 240 of 256 threads idle in A2 at
// C = 1, and one warp per neighbor in A1 left most lanes idle.)  The
// neighbor count needs each support row's feature sum; row_sums_kernel
// takes it once per row (a warp per row, the warp tree's order) instead
// of once per (query, neighbor), ~H times over.
// - C >= 32 (reduce_wide_kernel): A2, one thread per (query, channel
//   pair c, c + 32) with 2 x K accumulators, reads the features coalesced
//   and sums over h in order; each influence read serves two channels.
// - C < 32 (reduce_narrow_kernel; C = 1 is block 0's ones column): A1 also
//   stages the row's C features; A2, one thread per (query, kernel point,
//   channel), sums over h in order from shared memory and writes the
//   query's weighted row contiguously.
// Both give bit for bit the same `weighted` and nn as a warp-per-neighbor
// phase A: the same influence arithmetic, the same fmaf chain over h for
// each (k, c), the same row sums and count rule.
//
// Phase B (pcrcg_tc_gemm, tc_gemm.cuh): out[Nq, D] = weighted x W[K*C, D]
// on the tensor cores, error-compensated TF32 (three mma.sync products of
// the split operands, fp32 accumulation; fp32-grade results), with a
// cp.async ring and the split-K the host planner gives (ops/tc_gemm.py).
// The W contraction is part of the TPU kernel's body, so it is written
// here and not left to a library.
//
// What bounds it on the H100: at best, over the main path's 11 calls, the
// GEMM's 2 Nq K C D operations (~77 GFLOP: 0.47 ms as three TF32 passes
// at 495 TFLOP/s) and phase A's bytes (the scratch round trip and the
// H x C feature gathers at level 0).  What holds it now: phase B spends
// ~4 instructions per MMA (the operand split and the fragment loads sit
// in the inner loop) and waits on their latency, at about a fifth of the
// TF32 rate (chip_smoke.py prints it); phase A, the per-neighbor
// influences and the in-order sums over h.  Feeding phase A's output
// straight into the GEMM's A-operand producer (no `weighted` round trip
// when serving) and wgmma are later work.
#include <cuda_runtime.h>
#include <math.h>

#include "kpconv_common.cuh"
#include "tc_gemm.cuh"

namespace {

using pcrcg::kKMax;
constexpr int kThreads = 256;
constexpr int kNarrowC = 32;                // C below this takes the narrow kernel
constexpr size_t kSmemBudget = 96 * 1024;   // phase A's shared memory a block

struct Geometry {
  const float* q;
  int nq;
  const float* s;
  int ns;
  const float* feats;
  int c_in;
  const int* lidx;
  int h_count;
  const int* tiles;
  int m_tiles;
  int tile;
  const float* kp;
  int k_count;
  float extent;
  float gauss_denom;
  int influence;
  int closest;
  const float* rowsum;  // [ns]: each support row's feature sum, for the count
};

__device__ __forceinline__ void load_kp(const Geometry& geo, float* kps) {
  for (int i = threadIdx.x; i < 3 * kKMax; i += blockDim.x)
    kps[i] = i < 3 * geo.k_count ? geo.kp[i] : 0.0f;
}

// rowsum[r] = the features of support row r summed as a warp sums them
// (lanes stride the channels, then the xor butterfly), once per row: a
// neighbor counts when its row's sum is > 0.
__global__ void row_sums_kernel(const float* __restrict__ feats, int ns, int c_in,
                                float* __restrict__ rowsum) {
  const int lane = threadIdx.x & 31;
  const long long stride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < ns;
       r += stride) {
    float fs = 0.0f;
    for (int c = lane; c < c_in; c += 32) fs += feats[r * c_in + c];
    for (int off = 16; off > 0; off >>= 1) fs += __shfl_xor_sync(0xffffffffu, fs, off);
    if (lane == 0) rowsum[r] = fs;
  }
}

// Phase A1 for pair p = (query n0 + p / H, neighbor p % H) of a block:
// its support row (-1: shadow or past nq) into rows[p], the K influences
// (zero for a shadow) into wsm[p][0:kKMax], and the neighbor counted in
// cnt[p / H] when its row's feature sum is > 0.
__device__ __forceinline__ int stage_neighbor(const Geometry& geo, const float* kps, int n0,
                                              int p, float* wsm, int* rows, int* cnt) {
  const int qi = p / geo.h_count;
  const int h = p - qi * geo.h_count;
  const int n = n0 + qi;
  float w[kKMax];
  int row = -1;
  if (n < geo.nq) {
    row = pcrcg::support_row(geo.lidx, geo.tiles, n, h, geo.h_count, geo.m_tiles, geo.tile,
                             geo.ns);
  }
  if (row >= 0) {
    const float qx = geo.q[3 * (size_t)n], qy = geo.q[3 * (size_t)n + 1],
                qz = geo.q[3 * (size_t)n + 2];
    pcrcg::point_influences(__fsub_rn(geo.s[3 * (size_t)row], qx),
                            __fsub_rn(geo.s[3 * (size_t)row + 1], qy),
                            __fsub_rn(geo.s[3 * (size_t)row + 2], qz), kps, geo.k_count,
                            geo.influence, geo.extent, geo.gauss_denom, geo.closest, w);
    if (geo.rowsum[row] > 0.0f) atomicAdd(&cnt[qi], 1);
  } else {
#pragma unroll
    for (int k = 0; k < kKMax; ++k) w[k] = 0.0f;
  }
  float4* dst = reinterpret_cast<float4*>(wsm + (size_t)p * kKMax);
#pragma unroll
  for (int k4 = 0; k4 < kKMax / 4; ++k4)
    dst[k4] = make_float4(w[4 * k4], w[4 * k4 + 1], w[4 * k4 + 2], w[4 * k4 + 3]);
  rows[p] = row;
  return row;
}

// C < 32.  A1: one thread per (query, neighbor) stages the row's influences
// and its C features.  A2: one thread per (query, kernel point, channel)
// sums over h in order from shared memory and writes its entry of the
// query's contiguous weighted row.
__global__ void __launch_bounds__(kThreads)
    reduce_narrow_kernel(Geometry geo, int qpb, float* __restrict__ weighted,
                         float* __restrict__ nn) {
  extern __shared__ __align__(16) float smem[];
  const int h_count = geo.h_count, c_in = geo.c_in, kc = geo.k_count * geo.c_in;
  float* wsm = smem;                                    // [qpb][H][kKMax]
  float* fsm = wsm + (size_t)qpb * h_count * kKMax;     // [qpb][H][C]
  int* rows = reinterpret_cast<int*>(fsm + (size_t)qpb * h_count * c_in);  // [qpb][H]
  int* cnt = rows + qpb * h_count;                      // [qpb]
  float* kps = reinterpret_cast<float*>(cnt + qpb);     // [3 kKMax]
  const int n0 = blockIdx.x * qpb;

  for (int i = threadIdx.x; i < qpb; i += blockDim.x) cnt[i] = 0;
  load_kp(geo, kps);
  __syncthreads();

  for (int p = threadIdx.x; p < qpb * h_count; p += blockDim.x) {
    const int row = stage_neighbor(geo, kps, n0, p, wsm, rows, cnt);
    const float* fr = geo.feats + (size_t)(row < 0 ? 0 : row) * c_in;
    for (int c = 0; c < c_in; ++c) fsm[(size_t)p * c_in + c] = row < 0 ? 0.0f : fr[c];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < qpb * kc; idx += blockDim.x) {
    const int qi = idx / kc;
    const int r = idx - qi * kc;  // k * C + c
    const int n = n0 + qi;
    if (n >= geo.nq) continue;
    const int k = r / c_in;
    const int c = r - k * c_in;
    float acc = 0.0f;
    for (int h = 0; h < h_count; ++h) {
      const int p = qi * h_count + h;
      if (rows[p] < 0) continue;
      acc = fmaf(wsm[p * kKMax + k], fsm[p * c_in + c], acc);
    }
    weighted[(size_t)n * kc + r] = acc;
  }
  for (int i = threadIdx.x; i < qpb; i += blockDim.x) {
    if (n0 + i < geo.nq) nn[n0 + i] = (float)max(cnt[i], 1);
  }
}

// A2 work items of a query on the wide kernel: channel pairs (c, c + 32)
// with c in the first half of each 64-channel block.
__host__ __device__ __forceinline__ int wide_pairs(int c_in) { return (c_in + 63) / 64 * 32; }

// C >= 32.  A1: one thread per (query, neighbor) stages the influences.
// A2: one thread per (query, channel pair c, c + 32) with 2 K accumulators
// reads the features coalesced, summing over h in order; each influence
// read from shared memory serves both channels.
__global__ void __launch_bounds__(kThreads)
    reduce_wide_kernel(Geometry geo, int qpb, float* __restrict__ weighted,
                       float* __restrict__ nn) {
  extern __shared__ __align__(16) float smem[];
  const int h_count = geo.h_count, c_in = geo.c_in;
  float* wsm = smem;                                                 // [qpb][H][kKMax]
  int* rows = reinterpret_cast<int*>(wsm + (size_t)qpb * h_count * kKMax);  // [qpb][H]
  int* cnt = rows + qpb * h_count;                                   // [qpb]
  float* kps = reinterpret_cast<float*>(cnt + qpb);                  // [3 kKMax]
  const int n0 = blockIdx.x * qpb;

  for (int i = threadIdx.x; i < qpb; i += blockDim.x) cnt[i] = 0;
  load_kp(geo, kps);
  __syncthreads();

  for (int p = threadIdx.x; p < qpb * h_count; p += blockDim.x)
    stage_neighbor(geo, kps, n0, p, wsm, rows, cnt);
  __syncthreads();

  const int pairs = wide_pairs(c_in);  // per query
  for (int idx = threadIdx.x; idx < qpb * pairs; idx += blockDim.x) {
    const int qi = idx / pairs;
    const int r = idx - qi * pairs;
    const int c0 = (r >> 5) * 64 + (r & 31);
    const int c1 = c0 + 32;
    const bool has1 = c1 < c_in;
    const int n = n0 + qi;
    if (n >= geo.nq || c0 >= c_in) continue;
    float acc0[kKMax], acc1[kKMax];
#pragma unroll
    for (int k = 0; k < kKMax; ++k) acc0[k] = acc1[k] = 0.0f;
    for (int h = 0; h < h_count; ++h) {
      const int row = rows[qi * h_count + h];
      if (row < 0) continue;
      const float* fr = geo.feats + (size_t)row * c_in;
      const float f0 = fr[c0];
      const float f1 = has1 ? fr[c1] : 0.0f;
      const float4* wp = reinterpret_cast<const float4*>(wsm + (qi * h_count + h) * kKMax);
#pragma unroll
      for (int k4 = 0; k4 < kKMax / 4; ++k4) {
        const float4 w4 = wp[k4];
        acc0[4 * k4] = fmaf(w4.x, f0, acc0[4 * k4]);
        acc0[4 * k4 + 1] = fmaf(w4.y, f0, acc0[4 * k4 + 1]);
        acc0[4 * k4 + 2] = fmaf(w4.z, f0, acc0[4 * k4 + 2]);
        acc0[4 * k4 + 3] = fmaf(w4.w, f0, acc0[4 * k4 + 3]);
        acc1[4 * k4] = fmaf(w4.x, f1, acc1[4 * k4]);
        acc1[4 * k4 + 1] = fmaf(w4.y, f1, acc1[4 * k4 + 1]);
        acc1[4 * k4 + 2] = fmaf(w4.z, f1, acc1[4 * k4 + 2]);
        acc1[4 * k4 + 3] = fmaf(w4.w, f1, acc1[4 * k4 + 3]);
      }
    }
    float* out = weighted + (size_t)n * geo.k_count * c_in;
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (k < geo.k_count) {
        out[(size_t)k * c_in + c0] = acc0[k];
        if (has1) out[(size_t)k * c_in + c1] = acc1[k];
      }
    }
  }
  for (int i = threadIdx.x; i < qpb; i += blockDim.x) {
    if (n0 + i < geo.nq) nn[n0 + i] = (float)max(cnt[i], 1);
  }
}

// Shared memory of a block of qpb queries: influences, rows, counts, the
// kernel points, and for C < 32 the staged features.
size_t block_smem(int qpb, int h_count, int c_in) {
  const size_t per_pair = kKMax * sizeof(float) + sizeof(int) +
                          (c_in < kNarrowC ? c_in * sizeof(float) : 0);
  return (size_t)qpb * h_count * per_pair + qpb * sizeof(int) + 3 * kKMax * sizeof(float);
}

// Queries a block takes: enough that its (query, neighbor) pairs (A1) and
// its A2 items ((query, kernel point, channel) for C < 32, else (query,
// channel pair)), rounded to whole passes where they divide the block,
// each fill its threads, within the shared-memory budget.
int block_qpb(int c_in, int k_count, int h_count) {
  const int a2 = c_in < kNarrowC ? k_count * c_in : wide_pairs(c_in);
  int qpb = (kThreads + h_count - 1) / h_count;
  const int by_a2 = (kThreads + a2 - 1) / a2;
  if (by_a2 > qpb) qpb = by_a2;
  if (a2 < kThreads && kThreads % a2 == 0) {
    const int step = kThreads / a2;
    qpb = (qpb + step - 1) / step * step;
  }
  while (qpb > 1 && block_smem(qpb, h_count, c_in) > kSmemBudget) --qpb;
  return qpb;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemBudget);
}

}  // namespace

// Phase A.  q [nq, 3], s [ns, 3], feats [ns, c_in], lidx [>= nq, h_count]
// int32, tiles [groups, m_tiles] int32, kp [k_count, 3]; rowsum [ns]
// scratch -> weighted [nq, k_count * c_in] and nn [nq].  Two launches (the
// row sums, then the reduce); returns cudaGetLastError().
extern "C" int pcrcg_kpconv_tiled_reduce(const float* q, int nq, const float* s, int ns,
                                         const float* feats, int c_in, const int* lidx,
                                         int h_count, const int* tiles, int m_tiles, int tile,
                                         const float* kp, int k_count, float extent,
                                         float gauss_denom, int influence, int closest,
                                         float* rowsum, float* weighted, float* nn,
                                         void* stream) {
  if (nq <= 0) return 0;
  if (k_count > kKMax || k_count <= 0 || c_in <= 0 || h_count <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry geo{q,       nq,   s,  ns,      feats,  c_in,        lidx,      h_count,
                     tiles,   m_tiles, tile, kp, k_count, extent, gauss_denom, influence,
                     closest, rowsum};
  cudaStream_t st = (cudaStream_t)stream;
  if (ns > 0) {
    long long blocks = ((long long)ns * 32 + kThreads - 1) / kThreads;
    if (blocks > (1 << 16)) blocks = 1 << 16;
    row_sums_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(feats, ns, c_in, rowsum);
  }
  const int qpb = block_qpb(c_in, k_count, h_count);
  const size_t smem = block_smem(qpb, h_count, c_in);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  auto kernel = c_in < kNarrowC ? reduce_narrow_kernel : reduce_wide_kernel;
  if (cudaError_t e = allow_smem(kernel, smem)) return (int)e;
  kernel<<<(nq + qpb - 1) / qpb, kThreads, smem, st>>>(geo, qpb, weighted, nn);
  return (int)cudaGetLastError();
}

// Phase B.  C [M, N] = A [M, K] x B [K, N], fp32 row-major, on the plan
// of ops/tc_gemm.py::plan_gemm (`splits` partials of `k_chunk` rows;
// workspace [splits, M, N] when splits > 1).  trans_a / trans_b select
// the transposed layouts of tc_gemm.cuh (A stored [K, M], B stored
// [N, K]; not both), which K3 runs (csrc/kpconv_bwd.cu): this entry
// exposes them to the card tests and timing.  Returns a CUDA error code.
extern "C" int pcrcg_tc_gemm(const float* A, const float* B, float* C, int M, int N, int K,
                             int trans_a, int trans_b, int splits, int k_chunk,
                             float* workspace, void* stream) {
  using pcrcg::tc::gemm_3xtf32;
  cudaStream_t st = (cudaStream_t)stream;
  if (trans_a && trans_b) return (int)cudaErrorInvalidValue;
  if (trans_a)
    return (int)gemm_3xtf32<true, false>(M, N, K, splits, k_chunk, A, B, C, workspace, st);
  if (trans_b)
    return (int)gemm_3xtf32<false, true>(M, N, K, splits, k_chunk, A, B, C, workspace, st);
  return (int)gemm_3xtf32<false, false>(M, N, K, splits, k_chunk, A, B, C, workspace, st);
}
