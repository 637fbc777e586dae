// Device helpers shared by the KPConv kernels (K2 forward, K3 backward, K4
// scatter on the candidate tiles; K6 / K7 / K8 on gathered features):
// neighbor -> support row, and the influence of the K kernel points on one
// neighbor, computed exactly as the JAX kernels' _compute_wgt does
// (expanded |rel|^2 - 2 rel.kp + |kp|^2, each product and sum rounded
// once, no fused multiply-adds).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pcrcg {

constexpr int kGroup = 128;  // queries per tiled-search group
constexpr int kKMax = 16;    // kernel points held per thread / lane

// Global support row of neighbor h of query n: tiles[n / 128][l / tile] *
// tile + l % tile for the tile-local index l = lidx[n, h]; -1 for the
// shadow (l == m_tiles * tile) and for rows past ns.
__device__ __forceinline__ int support_row(const int* __restrict__ lidx,
                                           const int* __restrict__ tiles, int n, int h,
                                           int h_count, int m_tiles, int tile, int ns) {
  const int l = lidx[(size_t)n * h_count + h];
  if (l < 0 || l >= m_tiles * tile) return -1;
  const int r = tiles[(n / kGroup) * m_tiles + l / tile] * tile + l % tile;
  return r < ns ? r : -1;
}

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

// |rel - kp[k]|^2 in the expanded form, for kp[k] = (kx, ky, kz).
__device__ __forceinline__ float kp_sq_dist(float rx, float ry, float rz, float kx, float ky,
                                            float kz) {
  const float rel_sq =
      __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz));
  const float dot =
      __fadd_rn(__fadd_rn(__fmul_rn(rx, kx), __fmul_rn(ry, ky)), __fmul_rn(rz, kz));
  const float ksq =
      __fadd_rn(__fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky)), __fmul_rn(kz, kz));
  return __fadd_rn(__fsub_rn(rel_sq, __fmul_rn(2.0f, dot)), ksq);
}

// Influence of kernel point `lane` on the neighbor at rel = (rx, ry, rz),
// called by all 32 lanes of a warp together (lanes >= k_count return 0).
// With `closest` only the kernel points at the warp-wide minimum distance
// keep their weight.
__device__ __forceinline__ float lane_influence(float rx, float ry, float rz,
                                                const float* __restrict__ kp, int k_count,
                                                int lane, int influence, float extent,
                                                float gauss_denom, int closest) {
  float w = 0.0f;
  float d2 = INFINITY;
  if (lane < k_count) {
    d2 = kp_sq_dist(rx, ry, rz, kp[3 * lane], kp[3 * lane + 1], kp[3 * lane + 2]);
    w = influence_of(d2, influence, extent, gauss_denom);
  }
  if (closest) {
    float m = d2;
    for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (!(d2 <= m)) w = 0.0f;
  }
  return w;
}

// The same K influences computed by one thread into w[0:kKMax] (zero past
// k_count): bit for bit what lane_influence gives lane k.
__device__ __forceinline__ void point_influences(float rx, float ry, float rz,
                                                 const float* __restrict__ kp, int k_count,
                                                 int influence, float extent,
                                                 float gauss_denom, int closest,
                                                 float (&w)[kKMax]) {
  float d2[kKMax];
  float m = INFINITY;
#pragma unroll
  for (int k = 0; k < kKMax; ++k) {
    d2[k] = INFINITY;
    w[k] = 0.0f;
    if (k < k_count) {
      d2[k] = kp_sq_dist(rx, ry, rz, kp[3 * k], kp[3 * k + 1], kp[3 * k + 2]);
      w[k] = influence_of(d2[k], influence, extent, gauss_denom);
      m = fminf(m, d2[k]);
    }
  }
  if (closest) {
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      if (!(d2[k] <= m)) w[k] = 0.0f;
    }
  }
}

}  // namespace pcrcg
