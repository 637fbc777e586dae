// Candidate-tile squared distances for the tiled radius search (K1).
//
// Replaces the Pallas TPU kernel pcrcg_tpu/ops/search_kernel.py::_dist_kernel
// (wrapper tiled_candidate_distances).  For each 128-query group g the block
// reads its M candidate tile ids sel[g, :] itself (the TPU kernel took them by
// scalar prefetch), stages those tiles' x, y, z, |c|^2 rows in shared memory
// (4 * M * tile floats: 24 KB at M = 12, tile = 128) and writes
//
//     d2[g*128 + i, j] = (|q_i|^2 + |c_j|^2) - 2 q_i.c_j      (+inf if c_j invalid)
//
// in IEEE fp32.  The TPU kernel split the cross term into three bf16 limbs
// because Mosaic lowered an f32 dot to one bf16 MXU pass; Hopper's CUDA cores
// have real fp32, so the split is gone.  Every operation is rounded
// explicitly: |q|^2 and q.c as fused multiply-add chains over x, y, z
// (__fmaf_rn), the rest with __fadd_rn / __fsub_rn / __fmul_rn.  That is how
// the JAX package's compiled XLA search rounds on the CPU, and how the plain
// PyTorch version rounds, so all three rank near-tied neighbors alike.
//
// What bounds it on the H100: the bytes it writes.  The level-0 conv search
// writes 53,248 x 1,536 x 4 B = 327 MB of d2 (98 us at 3.35 TB/s) and reads
// well under 1 MB of tiles per group from L2; the arithmetic (7 flops per
// entry) is far below the fp32 rate.  So the design keeps the stores
// coalesced (consecutive threads write consecutive j of one query row) and
// keeps the candidates in shared memory, read once per group.  The top-k,
// the radius cutoff and the local -> global mapping stay in PyTorch.
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 128;  // queries per group
constexpr int kThreads = 256;

__global__ void tiled_distances_kernel(const float* __restrict__ queries, int nq,
                                       const float* __restrict__ supa,
                                       const int* __restrict__ sel, int m_tiles,
                                       int tile, float* __restrict__ d2) {
  extern __shared__ float smem[];
  const int cand = m_tiles * tile;
  float* cs = smem;              // [4][cand]: x, y, z, |c|^2
  float* qs = smem + 4 * cand;   // [kGroup][4]: x, y, z, |q|^2
  const int g = blockIdx.x;

  for (int i = threadIdx.x; i < 4 * cand; i += blockDim.x) {
    const int r = i / cand;
    const int j = i - r * cand;
    const int m = j / tile;
    const int t = j - m * tile;
    const int tile_id = sel[g * m_tiles + m];
    cs[i] = supa[((size_t)tile_id * 4 + r) * tile + t];
  }
  for (int i = threadIdx.x; i < kGroup; i += blockDim.x) {
    const int n = g * kGroup + i;
    float x = 0.f, y = 0.f, z = 0.f;
    if (n < nq) {
      x = queries[3 * (size_t)n];
      y = queries[3 * (size_t)n + 1];
      z = queries[3 * (size_t)n + 2];
    }
    qs[4 * i] = x;
    qs[4 * i + 1] = y;
    qs[4 * i + 2] = z;
    qs[4 * i + 3] = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
  }
  __syncthreads();

  float* out = d2 + (size_t)g * kGroup * cand;
  for (int i = 0; i < kGroup; ++i) {
    const float qx = qs[4 * i], qy = qs[4 * i + 1], qz = qs[4 * i + 2], qsq = qs[4 * i + 3];
    float* row = out + (size_t)i * cand;
    for (int j = threadIdx.x; j < cand; j += blockDim.x) {
      const float cross = __fmaf_rn(qz, cs[2 * cand + j],
                                    __fmaf_rn(qy, cs[cand + j], __fmul_rn(qx, cs[j])));
      row[j] = __fsub_rn(__fadd_rn(qsq, cs[3 * cand + j]), __fmul_rn(2.0f, cross));
    }
  }
}

}  // namespace

// queries [nq, 3], supa [n_tiles, 4, tile], sel [g_count, m_tiles] (int32),
// d2 [g_count * 128, m_tiles * tile].  Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int pcrcg_tiled_distances(const float* queries, int nq, const float* supa,
                                     int n_tiles, const int* sel, int g_count,
                                     int m_tiles, int tile, float* d2, void* stream) {
  (void)n_tiles;
  if (g_count <= 0) return 0;
  const size_t smem = (size_t)(4 * m_tiles * tile + 4 * kGroup) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(tiled_distances_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tiled_distances_kernel<<<g_count, kThreads, smem, (cudaStream_t)stream>>>(
      queries, nq, supa, sel, m_tiles, tile, d2);
  return (int)cudaGetLastError();
}
