// The tiled radius search in one launch (K1): candidate distances, exact
// top-k, radius cutoff and local -> global index mapping.
//
// Replaces the Pallas TPU kernel pcrcg_tpu/ops/search_kernel.py::_dist_kernel
// (wrapper tiled_candidate_distances) together with the XLA code that follows
// it in pcrcg_tpu/ops/tiled_search.py::radius_search_tiled_batch (top_k of
// -d2, the tile-table mapping, the cutoff).  For each 128-query group g with
// its M candidate tiles sel[g, :] (tile ids of the stacked clouds), query i
// and candidate j (position in the group's M * tile block):
//
//     d2[i, j] = (|q_i|^2 + |c_j|^2) - 2 q_i.c_j      (+inf if c_j invalid)
//
// rounded as the JAX package's compiled XLA search rounds on the CPU (and as
// the plain PyTorch version does): |q|^2 and q.c as fused multiply-add chains
// over x, y, z (__fmaf_rn), the rest with __fadd_rn / __fsub_rn / __fmul_rn,
// so nothing is contracted.  The kernel never writes d2.  It writes
//
//   idx  [B, Nq, k]     int64: the per-cloud support index, shadow Ns;
//   lidx [B, G*128, k]  int32: j, shadow M * tile (pad-query rows included);
//
// holding the k smallest (d2, j) in ascending order -- lower j first on equal
// d2, the order of a stable sort and of lax.top_k(-d2) -- and keeping those
// with d2 <= r^2.  Every entry past the cutoff is the shadow, so candidates
// with d2 > r^2 are dropped before ranking; the result is the same.  Two more
// modes: k = 1 (the upsample searches), the first minimum by (d2, j) within
// the radius; and the value mode of the loss's min_dist_sq_tiled, the
// smallest d2 of each query with no cutoff (bit for bit d2.amin(-1)).  The
// inputs are finite coordinates: a NaN distance is never in the radius.
//
// Ranking: each distance becomes a 64-bit key (order-preserving bits of d2,
// then j), so negative distances (near-coincident points round below zero)
// order correctly and keys are unique.  A warp takes one query at a time,
// lanes on consecutive j; a ballot compacts the in-radius survivors into the
// warp's buffer in j order.  When the buffer (cap >= k + 32 entries, 128 at
// k = 40) would overflow -- a dense cluster -- the warp keeps its k smallest
// keys (each entry's rank counted against all others), sorted, and from
// then on admits only keys below the k-th: ties with it come later in j and
// lose.  At the end each survivor's rank among the survivors is its output
// slot.  Every count of in-radius candidates, 0 to M * tile, is ranked here.
//
// What bounds it on the H100: arithmetic and shared-memory reads, not bytes.
// The outputs are 12 B per (query, slot) (26 MB at level 0: 8 us at
// 3.35 TB/s); the distances, 9 operations per (query, candidate) (0.74 GFLOP
// at level 0: 11 us at 67 TFLOP/s), each needs one 16-byte shared-memory
// read.  The block stages its group's candidates once as float4 (x, y, z,
// |c|^2): 24 KB at M = 12, tile = 128.  A group's 128 queries are split over
// grid y (qpb queries a block) until the grid has at least 8 blocks an SM:
// the small levels have only 12-144 groups, and at level 0 (416 groups)
// fewer, longer blocks leave the last wave mostly empty.  A warp takes the
// distances of two 32-wide candidate steps before it admits them, so the
// two chains overlap.  Measured side by side on one H100 over the 9
// searches of a serving pyramid (kernel_variants.py): 0.341 ms; 4 blocks an
// SM 0.380, 16 0.345, no split 0.755; one step at a time 0.363, four 0.356;
// without the ranking and its writes 0.322.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;  // queries per group
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCap = 128;  // survivor buffer entries a warp, at least
constexpr int kSteps = 2;     // 32-wide candidate steps whose distances a warp takes at once
constexpr int kMaxSmem = 232448;  // bytes a block may use on the H100
constexpr unsigned kFull = 0xffffffffu;
constexpr int kModeTopK = 0;
constexpr int kModeNearest = 1;
constexpr int kModeMinD2 = 2;

typedef unsigned long long u64;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float qsq, float4 c) {
  const float cross = __fmaf_rn(qz, c.z, __fmaf_rn(qy, c.y, __fmul_rn(qx, c.x)));
  return __fsub_rn(__fadd_rn(qsq, c.w), __fmul_rn(2.0f, cross));
}

// Unsigned bits in the order of the floats (negatives below positives).
__device__ __forceinline__ uint32_t order_bits(float d) {
  const uint32_t u = __float_as_uint(__fadd_rn(d, 0.0f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Rank of each of buf[0, cnt) among them (keys are unique); the `keep`
// smallest go to out[rank].  Called by the whole warp.
__device__ __forceinline__ void keep_smallest(const u64* buf, int cnt, int keep, u64* out,
                                              int lane) {
  __syncwarp();
  for (int e = lane; e < cnt; e += 32) {
    const u64 v = buf[e];
    int r = 0;
    for (int f = 0; f < cnt; ++f) r += buf[f] < v;
    if (r < keep) out[r] = v;
  }
  __syncwarp();
}

// Shared memory: candidates [cand] float4, the warps' survivor buffers
// [kWarps][2][cap] u64, the group's tile ids [m_tiles] int.
size_t smem_bytes(size_t cand, int m_tiles, int cap) {
  return (size_t)cand * sizeof(float4) + (size_t)kWarps * 2 * cap * sizeof(u64) +
         (size_t)m_tiles * sizeof(int);
}

int buffer_cap(int k, int mode) {
  if (mode != kModeTopK) return 0;
  const int cap = (k + 31) / 32 * 32 + 32;
  return cap < kMinCap ? kMinCap : cap;
}

// Grid (g_total, kGroup / qpb): block (g, y) takes queries y * qpb ..
// y * qpb + qpb - 1 of group g, warp w those w, w + kWarps, ...
__global__ void __launch_bounds__(kThreads)
    tiled_search_kernel(const float* __restrict__ queries, const float* __restrict__ supa,
                        const int* __restrict__ sel, int g_per_cloud, int m_tiles, int tile,
                        int n_tiles, int nq, int ns, int k, float r2, int qpb, int cap,
                        int mode, long long* __restrict__ idx, int* __restrict__ lidx,
                        float* __restrict__ min_d2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cand = m_tiles * tile;
  float4* cs = reinterpret_cast<float4*>(smem_raw);
  u64* bufs = reinterpret_cast<u64*>(cs + cand);
  int* sel_s = reinterpret_cast<int*>(bufs + (size_t)kWarps * 2 * cap);

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  for (int m = tid; m < m_tiles; m += kThreads) sel_s[m] = sel[(size_t)g * m_tiles + m];
  __syncthreads();
  for (int j = tid; j < cand; j += kThreads) {
    const int m = j / tile;
    const int t = j - m * tile;
    const float* s = supa + (size_t)sel_s[m] * 4 * tile + t;
    cs[j] = make_float4(s[0], s[tile], s[2 * tile], s[3 * tile]);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = g / g_per_cloud;
  const int q0 = (g - b * g_per_cloud) * kGroup;  // the group's first per-cloud query
  const int tile_base = b * n_tiles;              // the cloud's first stacked tile id
  u64* buf = bufs + (size_t)warp * 2 * cap;
  u64* alt = buf + cap;

  const int i_end = min(kGroup, (int)(blockIdx.y + 1) * qpb);
  for (int i = blockIdx.y * qpb + warp; i < i_end; i += kWarps) {
    const size_t row = (size_t)g * kGroup + i;
    const int qi = q0 + i;
    const float qx = queries[3 * row], qy = queries[3 * row + 1], qz = queries[3 * row + 2];
    const float qsq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, __fmul_rn(qx, qx)));

    if (mode == kModeMinD2) {
      float best = INFINITY;
      for (int j = lane; j < cand; j += 32) {
        const float d = sq_dist(qx, qy, qz, qsq, cs[j]);
        if (d < best || d != d) best = d;  // a NaN wins, as in amin
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(kFull, best, off);
        if (o < best || o != o) best = o;
      }
      if (lane == 0 && qi < nq) min_d2[(size_t)b * nq + qi] = best;
      continue;
    }

    // Slot s of this query's row holds candidate j (j == cand: the shadow).
    auto emit = [&](int s, int j) {
      lidx[row * k + s] = j;
      if (qi < nq) {
        long long gj = ns;
        if (j < cand) {
          const int m = j / tile;
          gj = (long long)(sel_s[m] - tile_base) * tile + (j - m * tile);
        }
        idx[((size_t)b * nq + qi) * k + s] = gj;
      }
    };

    if (mode == kModeNearest) {
      u64 best = ~0ull;
      for (int j = lane; j < cand; j += 32) {
        const float d = sq_dist(qx, qy, qz, qsq, cs[j]);
        if (d <= r2) {
          const u64 key = ((u64)order_bits(d) << 32) | (uint32_t)j;
          best = key < best ? key : best;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const u64 o = __shfl_xor_sync(kFull, best, off);
        best = o < best ? o : best;
      }
      if (lane == 0) emit(0, best == ~0ull ? cand : (int)(uint32_t)best);
      continue;
    }

    // Top-k: survivors in j order, compacted by ballot.
    int cnt = 0;
    uint32_t lim = 0xffffffffu;  // after a compaction: the k-th smallest key's bits
    const unsigned below = (1u << lane) - 1u;
    // Admit one 32-wide step of candidates (j = base + lane), in j order.
    auto admit = [&](int j, float d) {
      const bool valid = j < cand;
      const uint32_t bits = valid ? order_bits(d) : 0xffffffffu;
      bool pass = valid && d <= r2 && bits < lim;
      unsigned hits = __ballot_sync(kFull, pass);
      int c = __popc(hits);
      if (cnt + c > cap) {  // warp-uniform: keep the k smallest, then filter
        keep_smallest(buf, cnt, k, alt, lane);
        u64* tmp = buf;
        buf = alt;
        alt = tmp;
        cnt = k;
        lim = (uint32_t)(buf[k - 1] >> 32);
        pass = pass && bits < lim;
        hits = __ballot_sync(kFull, pass);
        c = __popc(hits);
      }
      if (pass) buf[cnt + __popc(hits & below)] = ((u64)bits << 32) | (uint32_t)j;
      cnt += c;
    };
    for (int base = 0; base < cand; base += 32 * kSteps) {
      float d[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int j = base + 32 * u + lane;
        d[u] = j < cand ? sq_dist(qx, qy, qz, qsq, cs[j]) : INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) admit(base + 32 * u + lane, d[u]);
    }
    __syncwarp();
    for (int e = lane; e < cnt; e += 32) {
      const u64 v = buf[e];
      int r = 0;
      for (int f = 0; f < cnt; ++f) r += buf[f] < v;
      if (r < k) emit(r, (int)(uint32_t)v);
    }
    for (int s = cnt + lane; s < k; s += 32) emit(s, cand);
    __syncwarp();  // the buffer is reused by the next query
  }
}

}  // namespace

// Shared-memory bytes the launch needs (mode 0: top-k, 1: k = 1, 2: value),
// at most INT_MAX.
extern "C" int pcrcg_tiled_search_smem(int m_tiles, int tile, int k, int mode) {
  const size_t bytes = smem_bytes((size_t)m_tiles * tile, m_tiles, buffer_cap(k, mode));
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}

// queries [g_total * 128, 3] (padded groups of the stacked clouds), supa
// [B * n_tiles, 4, tile], sel [g_total, m_tiles] int32 (stacked tile ids);
// g_per_cloud groups, n_tiles tiles, nq queries and ns supports a cloud.
// Modes 0 / 1 write idx [B, nq, k] int64 and lidx [B, g_per_cloud * 128, k]
// int32; mode 2 (k = 1) writes min_d2 [B, nq].  Returns a CUDA error code
// after the launch on `stream`.
extern "C" int pcrcg_tiled_search(const float* queries, const float* supa, const int* sel,
                                  int g_total, int g_per_cloud, int m_tiles, int tile,
                                  int n_tiles, int nq, int ns, int k, float r2, int mode,
                                  long long* idx, int* lidx, float* min_d2, void* stream) {
  if (g_total <= 0) return 0;
  const int cand = m_tiles * tile;
  if (m_tiles <= 0 || tile <= 0 || k < 1 || k > cand || g_per_cloud <= 0 ||
      g_total % g_per_cloud != 0 || mode < kModeTopK || mode > kModeMinD2 ||
      (mode != kModeTopK && k != 1))
    return (int)cudaErrorInvalidValue;
  const int cap = buffer_cap(k, mode);
  const size_t smem = smem_bytes(cand, m_tiles, cap);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(tiled_search_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int qpb = kGroup;
  while (qpb > kWarps && (long long)g_total * (kGroup / qpb) < 8LL * sms) qpb /= 2;
  const dim3 grid(g_total, kGroup / qpb);
  tiled_search_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      queries, supa, sel, g_per_cloud, m_tiles, tile, n_tiles, nq, ns, k, r2, qpb, cap, mode,
      idx, lidx, min_d2);
  return (int)cudaGetLastError();
}
