// K2: sparse-ELL spike delivery, with the ordered spike-id compaction.
//
// Replaces the TPU kernel repro/kernels/ell_deliver.py:ell_deliver_pallas
// (body _kernel, pallas_call at :110) and the jnp.nonzero compaction in
// repro/kernels/ops.py:54-55.  The TPU kernel scalar-prefetches the ids,
// gathers S row tiles and scatters into a ring update held in VMEM, which
// caps the ring's size; here the ring stays in device memory (in L2 at
// full scale) and the scatter is atomicAdd, so there is no cap.
//
// Three launches on one stream: count spikes per tile, write ranked ids (and
// the fill and the overflow), then scatter one (id, chunk) work item per
// block.  Bound: the real entries of the spiking rows, 12 B each read and a
// ring cell each updated (about 25 rows, 96k entries, 1.9 MB per step at
// full scale), plus the [N] spike vector; memory-bound.
// See ell_common.cuh for the design of both halves.
#include <algorithm>

#include "ell_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) count_kernel(
    const unsigned char* __restrict__ spiked, int n, int tile,
    int* __restrict__ counts) {
  __shared__ int smem[32];
  const int lo = min(static_cast<int>(blockIdx.x) * tile, n);
  const int hi = min(lo + tile, n);
  const int c = tile_count(spiked, lo, hi, smem);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kBlock) write_kernel(
    const unsigned char* __restrict__ spiked, int n, int tile,
    const int* __restrict__ counts, int* __restrict__ ids, int budget,
    int* __restrict__ overflow) {
  __shared__ int smem[32];
  int total;
  const int rank = tiles_before(counts, static_cast<int>(blockIdx.x),
                                static_cast<int>(gridDim.x), smem, &total);
  const int lo = min(static_cast<int>(blockIdx.x) * tile, n);
  const int hi = min(lo + tile, n);
  if (rank < budget) tile_write(spiked, lo, hi, rank, ids, budget, smem);
  compact_tail(total, ids, budget, n, overflow);
}

__global__ void __launch_bounds__(kBlock) scatter_kernel(
    const int* __restrict__ ids, EllTables tb, float* __restrict__ ring,
    int t, int d_bins, int n_cols, int n_exc) {
  const int sid = ids[blockIdx.x];
  if (sid >= n_cols - 1) return;        // the sentinel row: nothing to add
  const int j0 = blockIdx.y * kScatterChunk;
  scatter_chunk(tb, sid, j0, min(j0 + kScatterChunk, tb.k_pad), ring, t,
                d_bins, n_cols, n_exc);
}

}  // namespace

// Tile width of the compaction; the wrapper sizes `counts` to
// ceil(n / ell_compact_tile()).
EXPORT int ell_compact_tile() { return 8 * kBlock; }

EXPORT int ell_deliver_launch(const unsigned char* spiked, int n,
                              int* counts, int* ids, int budget,
                              int* overflow, const int* targets,
                              const float* weights, const int* dbins,
                              int k_pad, float* ring, int t, int d_bins,
                              int n_exc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = ell_compact_tile();
  const int n_tiles = std::max(1, (n + tile - 1) / tile);
  count_kernel<<<n_tiles, kBlock, 0, st>>>(spiked, n, tile, counts);
  write_kernel<<<n_tiles, kBlock, 0, st>>>(spiked, n, tile, counts, ids,
                                           budget, overflow);
  const EllTables tb{targets, weights, dbins, k_pad};
  const dim3 grid(budget, (k_pad + kScatterChunk - 1) / kScatterChunk);
  scatter_kernel<<<grid, kBlock, 0, st>>>(ids, tb, ring, t, d_bins, n + 1,
                                          n_exc);
  return static_cast<int>(cudaGetLastError());
}
