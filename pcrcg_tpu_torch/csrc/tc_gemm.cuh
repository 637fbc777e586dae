// Tensor-core fp32 GEMM for the KPConv W products: K2's W contraction
// (phase B of pcrcg_tpu/ops/kpconv_tiled.py::_build_kernel, whose TPU body
// contracts the reduced features with W in one bf16 MXU pass), K6's and
// K7's (phase B of pcrcg_tpu/ops/kpconv_fused.py::_fwd_kernel and
// ::_merged_fwd_kernel, csrc/kpconv_fused.cu: out = weighted_t^T W, the
// TRANS_A layout) and K3's two backward products
// (pcrcg_tpu/ops/kpconv_fused.py::_bwd_kernel, dW and gW,
// csrc/kpconv_bwd.cu):
//
//   C[M, N] = op(A)[M, K] x op(B)[K, N],   C row-major fp32
//
// op(A) is A [M, K] row-major or, with TRANS_A, the transpose of A stored
// [K, M] (K3's dW = weighted^T g, weighted stored [Nq, K*C]; K6 / K7's
// out = weighted_t^T W, weighted_t stored [K*C, N]); op(B) is
// B [K, N] row-major or, with TRANS_B, the transpose of B stored [N, K]
// (K3's gW = g W^T and W g^T).  Each operand is staged as it is stored,
// 16-byte copies along its contiguous axis, and read transposed from
// shared memory where the fragment wants the other axis.
//
// Error-compensated TF32 ("3xTF32").  Each operand element x is split with
// cvt.rna into big = tf32(x) and small = tf32(x - big), and every 16x8x8
// fragment product is three mma.sync.m16n8k8 TF32 products,
// small_a big_b + big_a small_b + big_a big_b (the two small ones first),
// accumulated in fp32.  Only small_a small_b (~2^-22 relative) is dropped,
// so the result is fp32-grade (~1e-6 relative) where one TF32 pass would
// give ~2^-11: the plain version (an fp32 matmul) and every tolerance of
// the port stay as they are.  The tensor cores' own fp32 accumulation
// does not round to nearest: over a long chain (2,880 MMAs for K =
// 7,680) its error missed 1e-5 of the largest entry against float64.  So
// each k-tile (12 MMAs a fragment) sums into fresh fragments, added to
// the running sum with round-to-nearest FADDs.
//
// What bounds it on the H100: the tensor cores' TF32 rate, 495 TFLOP/s
// dense, of which three passes leave 165 TFLOP/s of fp32-grade product
// (the CUDA cores' fp32 rate is 67).  What the design does about it:
// - 128 x 64 block tiles over 8 warps, each warp owning a 32 x 32 warp
//   tile (8 accumulator fragments and 8 k-tile sums, 127 registers), two
//   blocks an SM;
// - a 4-stage cp.async ring of A and B tiles (BK = 32, at most 110.6 KB)
//   in dynamic shared memory, so the next tiles load while the MMAs run;
//   rows padded (TileShape) so every fragment read is bank-conflict free,
//   in every layout;
// - split-K from a host-side planner (ops/tc_gemm.py::plan_gemm): with the
//   split operands converted in the inner loop the kernel is bound by
//   instruction throughput and latency, not by the tensor cores, so it
//   runs best with many blocks resident (several waves of them), also
//   where the output has few tiles and the reduction is long (K3's dW:
//   [960, 64] over 53,248 queries).  Block z writes its partial product
//   to a workspace, and a second kernel sums the partials in the fixed
//   order z = 0, 1, ..., so results are bit-identical run to run;
// - ragged edges: rows past M and columns past N are zero-filled by the
//   copies (cp.async src-size 0) and masked at the store; when a stored
//   operand's rows are not a multiple of 4 floats long (K*C = 15 at C = 1:
//   60-byte rows of K2's A and of K3's block-0 `weighted`) the tiles take
//   a 4-byte copy path instead of the 16-byte one.  A reduction shorter
//   than a k-tile (K6's block 0: K*C = 15 rows of weighted_t) is one tile
//   whose rows past K are zero-filled the same way.
// Each warp splits the fragment elements it reads, so an element is split
// once per warp that reads it.  Splitting each landed tile once instead,
// into big and small planes in shared memory (a second barrier a k-tile,
// twice the fragment loads, a 3-stage ring to make room), measured ~4 %
// slower on K2's and K3's products (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py).  wgmma is later work: its TF32 form wants both operands
// K-major, and B (W) is [K, N] row-major.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pcrcg {
namespace tc {

constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 8 warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, or a zero when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small, both TF32 (round to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kBN = 64;
constexpr int kStages = 4;

// A stage holds op(A)'s BM x BK tile as A stores it: [BM][BK + 4] (k
// contiguous), or with TRANS_A [BK][BM + 8] (m contiguous); B's BK x BN tile
// as [BK][BN + 8], or with TRANS_B [BN][BK + 4].  Pitches of 4 mod 32 floats
// where a fragment walks the rows (g) and 8 mod 32 where it walks the
// columns (t) put the 32 lanes of every fragment read in 32 banks.
template <bool TRANS_A, bool TRANS_B>
struct TileShape {
  static constexpr int kWarpsN = kBN / 32;         // 2
  static constexpr int kWarpsM = 8 / kWarpsN;      // 4
  static constexpr int kWM = kBM / kWarpsM;        // 32
  static constexpr int kMI = kWM / 16;             // m16 fragments per warp
  static constexpr int kNI = 32 / 8;               // n8 fragments per warp
  static constexpr int kLdA = TRANS_A ? kBM + 8 : kBK + 4;  // A row pitch (floats)
  static constexpr int kLdB = TRANS_B ? kBK + 4 : kBN + 8;  // B row pitch (floats)
  static constexpr int kAStage = (TRANS_A ? kBK : kBM) * kLdA;
  static constexpr int kBStage = (TRANS_B ? kBN : kBK) * kLdB;
  static constexpr size_t kSmemBytes = (size_t)kStages * (kAStage + kBStage) * sizeof(float);
};

// Starts the copies of the ROWS x COLS tile at (r0, c0) of a row-major
// matrix of row pitch `pitch` into dst (row pitch LD): rows from r_end and
// columns from c_end on are zero-filled.  VEC: 16-byte copies (pitch, c0
// and c_end multiples of 4, src 16-byte aligned).
template <int ROWS, int COLS, int LD, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int pitch, int r0,
                                          int r_end, int c0, int c_end, int tid) {
  if (VEC) {
#pragma unroll
    for (int i = tid; i < ROWS * (COLS / 4); i += kThreads) {
      const int r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < r_end && gc < c_end;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)gr * pitch + gc : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < r_end && gc < c_end;
      cp_async4(dst + r * LD + c, ok ? src + (size_t)gr * pitch + gc : src, ok);
    }
  }
}

// C = op(A) x op(B): op(A) [M, K] is A [M, K], or with TRANS_A the
// transpose of A stored [K, M]; op(B) [K, N] is B [K, N], or with TRANS_B
// the transpose of B stored [N, K].  Block (x, y, z) computes C tile (y, x)
// over k in [z k_chunk, (z + 1) k_chunk) and writes it to C + z M N (C
// itself when gridDim.z == 1).  VEC: both operands' stored rows are a
// multiple of 4 floats long and 16-byte aligned (16-byte copies).
template <bool TRANS_A, bool TRANS_B, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_3xtf32_kernel(int M, int N, int K, int k_chunk, const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ C) {
  using S = TileShape<TRANS_A, TRANS_B>;
  constexpr int BN = kBN, STAGES = kStages;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * S::kAStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int k_tiles = (k_end - k_begin + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = k_begin + kt * kBK;
    float* as = As + stage * S::kAStage;
    float* bs = Bs + stage * S::kBStage;
    if (TRANS_A)
      load_tile<kBK, kBM, S::kLdA, VEC>(as, A, M, k0, k_end, row0, M, tid);
    else
      load_tile<kBM, kBK, S::kLdA, VEC>(as, A, K, row0, M, k0, k_end, tid);
    if (TRANS_B)
      load_tile<BN, kBK, S::kLdB, VEC>(bs, B, K, col0, N, k0, k_end, tid);
    else
      load_tile<kBK, BN, S::kLdB, VEC>(bs, B, N, k0, k_end, col0, N, tid);
  };
  // op(A)[m, k] and op(B)[k, n] of a stage, tile-local indices.
  auto a_at = [](const float* as, int m, int k) {
    return TRANS_A ? as[k * S::kLdA + m] : as[m * S::kLdA + k];
  };
  auto b_at = [](const float* bs, int k, int n) {
    return TRANS_B ? bs[n * S::kLdB + k] : bs[k * S::kLdB + n];
  };

  float acc[S::kMI][S::kNI][4];
#pragma unroll
  for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load_stage(next % STAGES, next);
    cp_async_commit();

    const float* as = As + (kt % STAGES) * S::kAStage;
    const float* bs = Bs + (kt % STAGES) * S::kBStage;
    float part[S::kMI][S::kNI][4];
#pragma unroll
    for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < S::kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t b_big[S::kNI][2], b_small[S::kNI][2];
#pragma unroll
      for (int ni = 0; ni < S::kNI; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        split_tf32(b_at(bs, kk + t, n), b_big[ni][0], b_small[ni][0]);      // (k = t,     n = g)
        split_tf32(b_at(bs, kk + t + 4, n), b_big[ni][1], b_small[ni][1]);  // (k = t + 4, n = g)
      }
      uint32_t a_big[S::kMI][4], a_small[S::kMI][4];
#pragma unroll
      for (int mi = 0; mi < S::kMI; ++mi) {
        const int m = wm * S::kWM + mi * 16 + g;
        split_tf32(a_at(as, m, kk + t), a_big[mi][0], a_small[mi][0]);          // (g,     t)
        split_tf32(a_at(as, m + 8, kk + t), a_big[mi][1], a_small[mi][1]);      // (g + 8, t)
        split_tf32(a_at(as, m, kk + t + 4), a_big[mi][2], a_small[mi][2]);      // (g,     t + 4)
        split_tf32(a_at(as, m + 8, kk + t + 4), a_big[mi][3], a_small[mi][3]);  // (g + 8, t + 4)
      }
      // Each product over every fragment before the next, so consecutive
      // MMAs never wait on one another's accumulator.
#pragma unroll
      for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < S::kNI; ++ni) mma_tf32(part[mi][ni], a_small[mi], b_big[ni]);
#pragma unroll
      for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < S::kNI; ++ni) mma_tf32(part[mi][ni], a_big[mi], b_small[ni]);
#pragma unroll
      for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < S::kNI; ++ni) mma_tf32(part[mi][ni], a_big[mi], b_big[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < S::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < S::kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], part[mi][ni][e]);
  }
  cp_async_wait<0>();

  float* out = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < S::kMI; ++mi) {
    const int r = row0 + wm * S::kWM + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < S::kNI; ++ni) {
      const int c = col0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + 8 * half;
        if (rr >= M) continue;
        if (c < N) out[(size_t)rr * N + c] = acc[mi][ni][2 * half];
        if (c + 1 < N) out[(size_t)rr * N + c + 1] = acc[mi][ni][2 * half + 1];
      }
    }
  }
}

// out[i] = sum over z = 0, 1, ..., splits - 1 of ws[z][i], in that order.
// Many partials (K3's dW: up to ~200) are read 8 at a time, so a thread
// has 8 loads in flight before it adds them in order.
__global__ void sum_partials_kernel(const float* __restrict__ ws, int splits, size_t mn,
                                    float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    int z = 1;
    for (; z + 8 <= splits; z += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = ws[(size_t)(z + j) * mn + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    for (; z < splits; ++z) s += ws[(size_t)z * mn + i];
    out[i] = s;
  }
}

// C [M, N] = op(A) x op(B) (see gemm_3xtf32_kernel) in `splits` partials of
// `k_chunk` reduction rows each (the plan of ops/tc_gemm.py::plan_gemm);
// `workspace` holds splits x M x N floats when splits > 1 (unused
// otherwise).  Returns a CUDA error code: cudaErrorInvalidValue for a plan
// that does not cover K.
template <bool TRANS_A, bool TRANS_B>
inline cudaError_t gemm_3xtf32(int M, int N, int K, int splits, int k_chunk, const float* A,
                               const float* B, float* C, float* workspace, cudaStream_t st) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || splits < 1 || k_chunk < kBK || k_chunk % kBK != 0 ||
      (long long)splits * k_chunk < K || (long long)(splits - 1) * k_chunk >= K ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const bool vec = (TRANS_A ? M : K) % 4 == 0 && (TRANS_B ? K : N) % 4 == 0 &&
                   ((uintptr_t)A & 15) == 0 && ((uintptr_t)B & 15) == 0;
  auto kern = vec ? gemm_3xtf32_kernel<TRANS_A, TRANS_B, true>
                  : gemm_3xtf32_kernel<TRANS_A, TRANS_B, false>;
  constexpr size_t smem = TileShape<TRANS_A, TRANS_B>::kSmemBytes;
  // Set on every launch: a function-local static flag here would be one
  // object shared by every library that includes this header.
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  float* dst = splits > 1 ? workspace : C;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  kern<<<grid, kThreads, smem, st>>>(M, N, K, k_chunk, A, B, dst);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = (size_t)M * N;
  size_t blocks = (mn + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_partials_kernel<<<(unsigned)blocks, 256, 0, st>>>(workspace, splits, mn, C);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace pcrcg
