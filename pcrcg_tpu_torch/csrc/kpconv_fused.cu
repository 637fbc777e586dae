// KPConv forward over gathered features (K6) and over the merged gather of
// the strided blocks (K7).
//
// Replaces the Pallas TPU kernels pcrcg_tpu/ops/kpconv_fused.py::_fwd_kernel
// (wrapper kpconv_fused) and ::_merged_fwd_kernel (wrapper
// kpconv_fused_merged); this source is their phase A, and the wrappers
// (ops/kpconv_fused.py) run phase B after it.  Per query n, with nx_t
// [H, C, N] the gathered neighbor features (shadow rows zero):
//
//   w[n, h, k]      = influence(|rel[n, h] - kp[k]|^2)
//   weighted[n,k,c] = sum_h w[n, h, k] nx_t[h, c, n]
//   out[n, d]       = sum_{k,c} weighted[n, k, c] W[k, c, d]    (before / nn)
//   nn[n]           = max(1, #{h : sum_c nx_t[h, c, n] > 0})
//
// K7 reads the merged gather nxc_t [H, 8 + C, N]: rows 0-2 are the gathered
// absolute support coordinates (rows 3-7 zero), so rel = nxc_t[h, 0:3, n] -
// q[n] is computed in the kernel (a shadow row gathers zeros: rel = -q, a
// finite influence on zero features).  The TPU kernel contracts all 8 + C
// rows with W8 = [0_8 | W]; here the 8 coordinate/pad rows are skipped
// (c_skip = 8): weighted_t holds the C feature rows only and the product
// reduces over K*C with W's feature rows, which is the same output, since
// W8's first 8 rows are zero by contract.  nn sums the feature rows only
// -- the feature-only sum of the reference, not the TPU kernel's
// s_all - s_coord.
//
// The TPU kernels tiled queries 128 to the lanes, C in blocks of 128 and D
// in blocks of 256 over an (n, d, c) grid that revisits each output tile,
// and contracted W on the MXU inside the same body; that blocking is
// Mosaic's.  Here two launches, as K2's:
//   Phase A (pcrcg_kpconv_gathered_reduce, kpconv_gathered.cuh): the
//   influences and weighted_t [K*C, N], queries on lanes, and nn from the
//   same reads of nx_t.
//   Phase B (pcrcg_tc_gemm of kpconv_tiled.cu, tc_gemm.cuh in the TRANS_A
//   layout): out [N, D] = weighted_t^T x W on the tensor cores,
//   error-compensated TF32 (fp32-grade), on the split-K plan of
//   ops/tc_gemm.py::plan_gemm.  The W contraction is part of the TPU
//   kernel's body, so it is written by hand and not left to a library.
//
// What bounds it on the H100: at level 0 the bytes of nx_t (53,248 x 40 x
// 64 x 4 B = 545 MB for the (64, 64) conv, 0.16 ms at 3.35 TB/s); at levels
// 2-3 the product's operations (2 N K C D, as three TF32 passes at 495
// TFLOP/s).  The scratch weighted_t round trip and the separate gather
// (torch, outside the kernel, as the JAX wrapper leaves it to XLA) are
// what fusing would remove -- later work, as are wgmma tiles.
#include <cuda_runtime.h>

#include "kpconv_gathered.cuh"

// Phase A of K6 (rel [n, h_count, 3], q null, c_skip 0) and of K7 (q
// [n, 3], rel null, c_skip 8: coordinates in rows 0-2 of nx_t).  nx_t
// [h_count, c_total, n], kp [k_count, 3] -> weighted_t [k_count * (c_total
// - c_skip), n] and nn [n] (not written when null).  `split` is
// ops/kpconv_fused.py::phase_a_split's; nn_part [split, h_count, n] scratch
// where it is more than one (null otherwise).  Returns a CUDA error code
// after the launches on `stream`.
extern "C" int pcrcg_kpconv_gathered_reduce(const float* rel, const float* q,
                                            const float* nx_t, int n, int h_count, int c_total,
                                            int c_skip, const float* kp, int k_count,
                                            float extent, float gauss_denom, int influence,
                                            int closest, int split, float* nn_part,
                                            float* weighted_t, float* nn, void* stream) {
  return (int)pcrcg::launch_gathered_reduce(rel, q, nx_t, n, h_count, c_total, c_skip, kp,
                                            k_count, extent, gauss_denom, influence, closest,
                                            split, weighted_t, nn, nn_part,
                                            (cudaStream_t)stream);
}
