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
// Phase B (sgemm_kernel): a shared-memory-tiled fp32 GEMM,
// out[Nq, D] = weighted[Nq, K*C] x W[K*C, D], 64 x 64 tiles, 4 x 4 outputs a
// thread.  The W contraction is part of the TPU kernel's body, so it is
// written here and not left to a library.
//
// What bounds it on the H100: at the wide levels (C, D >= 128) the GEMM's
// operations (2 Nq K C D: 12 GFLOP for the level-3 512 x 512 convs, 0.18 ms
// at 67 TFLOP/s fp32); at level 0 the bytes of the scratch round trip and
// the H x C feature gathers.  This first version keeps every operand in fp32
// on the CUDA cores; wgmma/TF32 tiles and fusing phase B into phase A (to
// drop the scratch) are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroup = 128;   // queries per tiled-search group
constexpr int kKMax = 16;     // kernel points held per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float influence_of(float d2, int influence, float extent,
                                              float gauss_denom) {
  if (influence == 1) {  // linear
    return fmaxf(__fsub_rn(1.0f, __fdiv_rn(sqrtf(fmaxf(d2, 0.0f)), extent)), 0.0f);
  }
  if (influence == 2) {  // gaussian
    return expf(__fdiv_rn(-d2, gauss_denom));
  }
  return 1.0f;  // constant
}

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
  const int shadow = m_tiles * tile;

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
      const int l = lidx[(size_t)n * h_count + h];
      if (l >= 0 && l < shadow) {
        const int r = tiles[(n / kGroup) * m_tiles + l / tile] * tile + l % tile;
        if (r < ns) row = r;
      }
      const float qx = q[3 * (size_t)n], qy = q[3 * (size_t)n + 1], qz = q[3 * (size_t)n + 2];
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      if (row >= 0) {
        sx = s[3 * (size_t)row];
        sy = s[3 * (size_t)row + 1];
        sz = s[3 * (size_t)row + 2];
      }
      const float rx = __fsub_rn(sx, qx), ry = __fsub_rn(sy, qy), rz = __fsub_rn(sz, qz);
      float d2 = INFINITY;
      if (lane < k_count) {
        const float kx = kp[3 * lane], ky = kp[3 * lane + 1], kz = kp[3 * lane + 2];
        const float rel_sq =
            __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz));
        const float dot =
            __fadd_rn(__fadd_rn(__fmul_rn(rx, kx), __fmul_rn(ry, ky)), __fmul_rn(rz, kz));
        const float ksq =
            __fadd_rn(__fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky)), __fmul_rn(kz, kz));
        d2 = __fadd_rn(__fsub_rn(rel_sq, __fmul_rn(2.0f, dot)), ksq);
        w = influence_of(d2, influence, extent, gauss_denom);
      }
      if (closest) {
        float m = d2;
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (!(d2 <= m)) w = 0.0f;
      }
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

constexpr int kBM = 64, kBN = 64, kBK = 16;

// C[M, N] = A[M, K] x B[K, N], all row-major fp32.  256 threads; thread
// (tx, ty) owns rows ty + 16 i and columns tx + 16 j (i, j < 4).
__global__ void sgemm_kernel(int M, int N, int K, const float* __restrict__ A,
                             const float* __restrict__ B, float* __restrict__ C) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int r = i / kBK, kk = i - r * kBK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.0f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int kk = i / kBN, cc = i - kk * kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      Bs[kk][cc] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(size_t)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// q [nq, 3], s [ns, 3], feats [ns, c_in], lidx [>= nq, h_count] int32,
// tiles [groups, m_tiles] int32, kp [k_count, 3], W [k_count * c_in, d];
// scratch weighted [nq, k_count * c_in]; outputs out [nq, d] (before the
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
  dim3 grid((d + kBN - 1) / kBN, (nq + kBM - 1) / kBM);
  sgemm_kernel<<<grid, kThreads, 0, st>>>(nq, d, k_count * c_in, weighted, W, out);
  return (int)cudaGetLastError();
}
