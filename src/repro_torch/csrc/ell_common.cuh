// Device pieces of the sparse-ELL spike delivery: the ordered compaction,
// shared by ell_deliver.cu (K2, three plain launches) and spike_deliver.cu
// (K5), and K2's scatter.  (K3 and K4 in lif_deliver.cu compact in one
// pass by decoupled look-back instead.)
//
// Ordered compaction.  The reference takes jnp.nonzero(spiked, size=budget,
// fill_value=N): the LOWEST `budget` spiking ids in ascending order, then
// the sentinel N.  Which spikes an overflow drops is part of the result, so
// an atomic-counter compaction (arbitrary order) would not do.  Here the
// neurons are cut into one tile per block: each block counts its tile, and
// in a second launch each block sums the counts of the tiles before it and
// writes its spikes' ranks with a block-wide prefix scan.  Ranks at or past
// `budget` are dropped.
//
// Scatter.  Each spiking row's K_pad (target, weight, delay-bin) entries are
// split into chunks; a block's threads stride over a chunk and atomicAdd
// each weight into ring[(t + dbin) % D, ch, target], ch = (sid >= n_exc)
// (Dale's law).  Padded entries (target N, weight 0) are skipped.  The ring
// ([D, 2, N+1] f32, 28 MB at full scale) stays in the 50 MB L2.  Float
// atomics sum in no fixed order, so the ring agrees with the plain version
// to a tolerance, not bit for bit; ids and overflow are exact.
#pragma once

#include "common.cuh"

constexpr int kScatterChunk = 1024;   // row entries per scatter work item

// Block-wide exclusive prefix sum of one int per thread (blockDim a multiple
// of 32, at most 1024).  `smem` holds 32 ints.  Returns the exclusive
// prefix and sets *total to the block's sum.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? smem[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    smem[lane] = w;                     // inclusive warp-total prefix
  }
  __syncthreads();
  const int before = warp > 0 ? smem[warp - 1] : 0;
  *total = smem[n_warps - 1];
  __syncthreads();                      // smem is free again on return
  return before + x - v;
}

// Spikes in [lo, hi) counted by one block.
__device__ __forceinline__ int tile_count(const unsigned char* spiked, int lo,
                                          int hi, int* smem) {
  int c = 0;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) c += spiked[i] != 0;
  int total;
  block_exclusive_scan(c, smem, &total);
  return total;
}

// This block's first rank (sum of the counts of the tiles before it) and
// the spike total over all n_tiles tiles.
__device__ __forceinline__ int tiles_before(const int* counts, int tile,
                                            int n_tiles, int* smem,
                                            int* total) {
  int before = 0, all = 0;
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x) {
    const int c = counts[j];
    all += c;
    if (j < tile) before += c;
  }
  int sum_before;
  block_exclusive_scan(before, smem, &sum_before);
  block_exclusive_scan(all, smem, total);
  return sum_before;
}

// Writes the ids of the spikes in [lo, hi), ranked from `rank`, into
// ids[rank] while rank < budget.
__device__ __forceinline__ void tile_write(const unsigned char* spiked,
                                           int lo, int hi, int rank,
                                           int* ids, int budget, int* smem) {
  for (int base = lo; base < hi; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int f = (i < hi && spiked[i]) ? 1 : 0;
    int chunk_total;
    const int pos = rank + block_exclusive_scan(f, smem, &chunk_total);
    if (f && pos < budget) ids[pos] = i;
    rank += chunk_total;
    if (rank >= budget) break;          // uniform across the block
  }
}

// The fill and the overflow, given the spike total: ids[total:budget] = N,
// and *overflow = max(total - budget, 0).  Strided over the whole grid.
__device__ __forceinline__ void compact_tail(int total, int* ids, int budget,
                                             int n, int* overflow) {
  const int stride = gridDim.x * blockDim.x;
  for (int p = total + blockIdx.x * blockDim.x + threadIdx.x; p < budget;
       p += stride)
    ids[p] = n;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *overflow = total > budget ? total - budget : 0;
}

struct EllTables {
  const int* targets;    // [N+1, k_pad], sentinel target N
  const float* weights;  // [N+1, k_pad]
  const int* dbins;      // [N+1, k_pad], >= 1
  int k_pad;
};

// Scatters entries [j0, j1) of source row `sid` into the ring at phase t.
__device__ __forceinline__ void scatter_chunk(
    const EllTables& tb, int sid, int j0, int j1, float* ring, int t,
    int d_bins, int n_cols, int n_exc) {
  const int n = n_cols - 1;
  const int ch = sid >= n_exc ? 1 : 0;
  const size_t row = static_cast<size_t>(sid) * tb.k_pad;
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const int tg = tb.targets[row + j];
    if (tg >= n) continue;              // padding: weight 0 into the dump
    const int slot = (t + tb.dbins[row + j]) % d_bins;
    const float w = tb.weights[row + j];
    atomicAdd(ring + (static_cast<size_t>(slot) * 2 + ch) * n_cols + tg, w);
  }
}
