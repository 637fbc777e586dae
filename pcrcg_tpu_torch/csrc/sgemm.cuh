// Shared-memory-tiled fp32 GEMM for K6 and K7's W contraction
// (csrc/kpconv_fused.cu: out = weighted_t^T x W, the TRANS_A layout), its
// only callers since K3's products moved to the tensor cores.
//
//   C[z][M, N] = op(A)[M, k0:k1] x op(B)[k0:k1, N],  k0 = z * k_chunk
//
// op(A) is A [M, K] row-major, or with TRANS_A the transpose of A [K, M];
// op(B) is B [K, N] row-major, or with TRANS_B the transpose of B [N, K].
// blockIdx.z splits the reduction (split-K): block z writes its partial
// product to C + z * M * N, and the caller sums the partials.  64 x 64
// output tiles, 256 threads; thread (tx, ty) owns rows ty + 16 i and
// columns tx + 16 j (i, j < 4).  Operand loads walk the contiguous axis
// of each operand, so neighbouring threads read neighbouring addresses in
// every layout.  Everything stays fp32 on the CUDA cores.  K2's W
// contraction and K3's dW and gW run on the tensor cores instead
// (tc_gemm.cuh: three TF32 products of the split operands, fp32-grade);
// moving K6 and K7 there (its TRANS_A layout) is later work.  A copy cut
// down to the one layout and no split measured 2-5 % slower for K6 and
// K7 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py), so the general
// kernel stays.
#pragma once

#include <cuda_runtime.h>

namespace pcrcg {

constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 16, kGemmThreads = 256;

template <bool TRANS_A, bool TRANS_B>
__global__ void sgemm_kernel(int M, int N, int K, int k_chunk, const float* __restrict__ A,
                             const float* __restrict__ B, float* __restrict__ C) {
  __shared__ float As[kGemmBK][kGemmBM + 1];
  __shared__ float Bs[kGemmBK][kGemmBN + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kGemmBM;
  const int col0 = blockIdx.x * kGemmBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kGemmBK) {
    for (int i = threadIdx.x; i < kGemmBM * kGemmBK; i += blockDim.x) {
      int r, kk;
      if (TRANS_A) {  // A [K, M]: consecutive threads on consecutive rows m
        r = i % kGemmBM;
        kk = i / kGemmBM;
      } else {  // A [M, K]: consecutive threads on consecutive k
        r = i / kGemmBK;
        kk = i % kGemmBK;
      }
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.0f;
      if (gr < M && gk < k_end) v = TRANS_A ? A[(size_t)gk * M + gr] : A[(size_t)gr * K + gk];
      As[kk][r] = v;
    }
    for (int i = threadIdx.x; i < kGemmBK * kGemmBN; i += blockDim.x) {
      int cc, kk;
      if (TRANS_B) {  // B [N, K]: consecutive threads on consecutive k
        cc = i / kGemmBK;
        kk = i % kGemmBK;
      } else {  // B [K, N]: consecutive threads on consecutive columns n
        cc = i % kGemmBN;
        kk = i / kGemmBN;
      }
      const int gk = k0 + kk, gc = col0 + cc;
      float v = 0.0f;
      if (gk < k_end && gc < N) v = TRANS_B ? B[(size_t)gc * K + gk] : B[(size_t)gk * N + gc];
      Bs[kk][cc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
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
  float* out = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// Launch sgemm_kernel with the reduction cut into chunks of `k_chunk`
// (>= K: a plain GEMM writing C [M, N]; else ceil(K / k_chunk) partial
// products); returns cudaGetLastError().
template <bool TRANS_A, bool TRANS_B>
inline cudaError_t launch_sgemm(int M, int N, int K, int k_chunk, const float* A,
                                const float* B, float* C, cudaStream_t st) {
  if (k_chunk < 1) k_chunk = K > 0 ? K : 1;
  const int splits = K > 0 ? (K + k_chunk - 1) / k_chunk : 1;
  dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM, splits);
  sgemm_kernel<TRANS_A, TRANS_B><<<grid, kGemmThreads, 0, st>>>(M, N, K, k_chunk, A, B, C);
  return cudaGetLastError();
}

}  // namespace pcrcg
