// KPConv forward over gathered features (K6) and over the merged gather of
// the strided blocks (K7).
//
// Replaces the Pallas TPU kernels pcrcg_tpu/ops/kpconv_fused.py::_fwd_kernel
// (wrapper kpconv_fused) and ::_merged_fwd_kernel (wrapper
// kpconv_fused_merged).  Per query n, with nx_t [H, C, N] the gathered
// neighbor features (shadow rows zero):
//
//   w[n, h, k]      = influence(|rel[n, h] - kp[k]|^2)
//   weighted[n,k,c] = sum_h w[n, h, k] nx_t[h, c, n]
//   out[n, d]       = sum_{k,c} weighted[n, k, c] W[k, c, d]    (before / nn)
//   nn[n]           = max(1, #{h : sum_c nx_t[h, c, n] > 0})
//
// K7 reads the merged gather nxc_t [H, 8 + C, N]: rows 0-2 are the gathered
// absolute support coordinates (rows 3-7 zero), so rel = nxc_t[h, 0:3, n] -
// q[n] is computed in the kernel (a shadow row gathers zeros: rel = -q, a
// finite influence on zero features); W8 [K, 8 + C, D] carries 8 zero rows
// over the coordinate rows, and nn sums the feature rows (>= 8) only -- the
// feature-only sum of the reference, not the TPU kernel's s_all - s_coord.
//
// The TPU kernels tiled queries 128 to the lanes, C in blocks of 128 and D
// in blocks of 256 over an (n, d, c) grid that revisits each output tile,
// and contracted W on the MXU inside the same body; that blocking is
// Mosaic's.  Here:
//   Phase A (gathered_reduce_kernel, kpconv_gathered.cuh): a block takes 32
//   consecutive queries, one per lane, so every read of nx_t is coalesced;
//   it computes the tile's influences into shared memory (a thread per
//   (neighbor, query)), the neighbor counts, and weighted_t [K*C, N] (a warp
//   per channel, K accumulators a thread).
//   Phase B (sgemm.cuh): out [N, D] = weighted_t^T x W, the hand-written
//   fp32 GEMM K2 and K3 use; the W contraction is part of the TPU kernel's
//   body, so it is written here and not left to a library.
//
// What bounds it on the H100: at level 0 the bytes of nx_t (53,248 x 40 x
// 64 x 4 B = 545 MB for the (64, 64) conv, 0.16 ms at 3.35 TB/s), which
// phase A reads twice (the neighbor sums, then the reduce; the second pass
// finds much of the block's tile in L2); at levels 2-3 the GEMM's
// operations (2 N K C D).  The scratch weighted_t round trip and the
// separate gather (torch, outside the kernel, as the JAX wrapper leaves it
// to XLA) are what fusing would remove -- later work, as are wgmma tiles.
#include <cuda_runtime.h>

#include "kpconv_gathered.cuh"
#include "sgemm.cuh"

namespace {

using pcrcg::kKMax;

int fused_forward(const float* rel, const float* q, const float* nx_t, int n, int h_count,
                  int c_total, int c_skip, const float* kp, int k_count, const float* W, int d,
                  float extent, float gauss_denom, int influence, int closest,
                  float* weighted_t, float* out, float* nn, void* stream) {
  if (n <= 0) return 0;
  if (k_count > kKMax || k_count <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = pcrcg::launch_gathered_reduce(rel, q, nx_t, n, h_count, c_total, c_skip, kp,
                                                k_count, extent, gauss_denom, influence,
                                                closest, weighted_t, nn, st);
  if (e != cudaSuccess) return (int)e;
  const int kc = k_count * c_total;
  return (int)pcrcg::launch_sgemm<true, false>(n, d, kc, kc, weighted_t, W, out, st);
}

}  // namespace

// K6.  rel [n, h_count, 3], nx_t [h_count, c_in, n], kp [k_count, 3],
// W [k_count * c_in, d]; weighted_t [k_count * c_in, n] (phase A's output,
// scratch), out [n, d] (before the division by nn) and nn [n].  Returns
// cudaGetLastError() after the launches on `stream`.
extern "C" int pcrcg_kpconv_fused(const float* rel, const float* nx_t, int n, int h_count,
                                  int c_in, const float* kp, int k_count, const float* W,
                                  int d, float extent, float gauss_denom, int influence,
                                  int closest, float* weighted_t, float* out, float* nn,
                                  void* stream) {
  return fused_forward(rel, nullptr, nx_t, n, h_count, c_in, 0, kp, k_count, W, d, extent,
                       gauss_denom, influence, closest, weighted_t, out, nn, stream);
}

// K7.  q [n, 3], nxc_t [h_count, c8, n] with c8 = 8 + C (coordinates in rows
// 0-2), W8 [k_count * c8, d]; outputs as K6's, weighted_t [k_count * c8, n].
extern "C" int pcrcg_kpconv_fused_merged(const float* q, const float* nxc_t, int n,
                                         int h_count, int c8, const float* kp, int k_count,
                                         const float* W8, int d, float extent,
                                         float gauss_denom, int influence, int closest,
                                         float* weighted_t, float* out, float* nn,
                                         void* stream) {
  if (c8 < 8) return (int)cudaErrorInvalidValue;
  return fused_forward(nullptr, q, nxc_t, n, h_count, c8, 8, kp, k_count, W8, d, extent,
                       gauss_denom, influence, closest, weighted_t, out, nn, stream);
}
