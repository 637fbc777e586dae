// The scatter of K5's backward (the strided shortcut's max-pool) onto the
// support rows.  K4's scatter (the feature gradient of kpconv_tiled_ad) runs
// inside K3's candidate-tile entry, csrc/kpconv_bwd.cu, which resolves each
// (query, neighbor) row already and so never writes dnx.
//
// K5 replaces pcrcg_tpu/ops/kpconv_tiled.py::_maxpool_bwd_kernel (+ the
// XLA tile scatter after it):
//     ds[inds[q, amax[q, c]], c] += g[q, c]   (shadow rows dropped)
// with amax the first-maximum neighbor the forward saved, and the global
// neighbor index taken directly (no lidx / tiles needed on a GPU).
//
// The TPU kernel turned the row scatter into per-group one-hot MXU matmuls
// with bf16 hi/lo limbs, then a tile-granular one-hot matmul, because TPU
// scatters are slow.  A GPU has native fp32 atomics in L2, so it is one
// pass of atomicAdd, with one resolve per query.  A block takes a group of
// queries, stages each one's H global rows (inds[q, :], int64) in shared
// memory once, as int32 with shadows marked, then its threads walk the
// group's (query, channel) entries: amax[q, c] and g[q, c] read coalesced,
// the row resolved from shared memory, one atomicAdd.  So no entry waits on
// a dependent global read of inds.  The group holds ~1,024 entries (one
// query at C = 1,024): one warp per query, walking the channels, left the
// deepest shortcut's backward (1,536 queries x 1,024 channels) 1,536 warps
// of 32 serial steps, slower than a thread per entry.  The output's zero
// fill is a memset on the same stream inside the C entry.
// The sum order changes from run to run (atomics), so results are not
// bit-reproducible: callers hold them to a relative tolerance.  A
// deterministic segmented sum is later work.
//
// What bounds it on the H100: bytes.  It reads g and amax and updates ds.
// amax arrives as int64 (the forward's torch.max indices), 8 bytes an
// entry where the function needs one, and atomics on contended rows (each
// support row is a neighbor of ~H queries) are the other limit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr int kPoolEntries = 1024;  // (query, channel) entries a block group holds

__global__ void maxpool_bwd_kernel(const float* __restrict__ g,
                                   const long long* __restrict__ amax,
                                   const long long* __restrict__ inds, int nq, int h_count,
                                   int c_in, int ns, int qpb, float* __restrict__ ds) {
  extern __shared__ int staged[];  // [qpb][h_count]
  for (long long q0 = (long long)blockIdx.x * qpb; q0 < nq; q0 += (long long)gridDim.x * qpb) {
    const int group = (int)min((long long)qpb, nq - q0);
    const long long* rows = inds + q0 * h_count;
    for (int i = threadIdx.x; i < group * h_count; i += blockDim.x) {
      const long long r = rows[i];
      staged[i] = (r >= 0 && r < ns) ? (int)r : -1;
    }
    __syncthreads();
    const long long base = q0 * c_in;
    for (int i = threadIdx.x; i < group * c_in; i += blockDim.x) {
      const int qi = i / c_in;
      const long long h = amax[base + i];
      if (h < 0 || h >= h_count) continue;
      const int r = staged[qi * h_count + (int)h];
      if (r >= 0) atomicAdd(ds + (size_t)r * c_in + (i - qi * c_in), g[base + i]);
    }
    __syncthreads();  // staged is rewritten for the next group
  }
}

// Blocks for one thread per work item, capped at kBlocksPerSm blocks per SM
// of the current device (the kernels' grid-stride loops take the rest).
constexpr int kBlocksPerSm = 32;

cudaError_t grid_for(size_t work, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t blocks = (work + kThreads - 1) / kThreads;
  const size_t cap = (size_t)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  *grid = blocks < 1 ? 1 : (int)blocks;
  return err;
}

}  // namespace

// K5 backward: g [nq, c_in] f32, amax [nq, c_in] int64 (neighbor slot of the
// first maximum), inds [nq, h_count] int64 (global rows, >= ns = shadow) ->
// ds [ns, c_in] f32, zeroed here first (a memset on `stream`).
extern "C" int pcrcg_maxpool_bwd(const float* g, const long long* amax, const long long* inds,
                                 int nq, int h_count, int c_in, int ns, float* ds,
                                 void* stream) {
  if (ns <= 0 || c_in <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(ds, 0, (size_t)ns * c_in * sizeof(float), st))
    return (int)err;
  if (nq <= 0) return 0;
  if (h_count <= 0) return (int)cudaErrorInvalidValue;
  int qpb = kPoolEntries / c_in;
  const int smem_cap = (int)(48 * 1024 / (h_count * sizeof(int)));
  qpb = qpb < 1 ? 1 : (qpb > smem_cap ? smem_cap : qpb);
  if (qpb < 1) return (int)cudaErrorInvalidValue;
  int grid = 0;
  if (cudaError_t err = grid_for(((size_t)nq + qpb - 1) / qpb * kThreads, &grid)) return (int)err;
  maxpool_bwd_kernel<<<grid, kThreads, (size_t)qpb * h_count * sizeof(int), st>>>(
      g, amax, inds, nq, h_count, c_in, ns, qpb, ds);
  return (int)cudaGetLastError();
}
