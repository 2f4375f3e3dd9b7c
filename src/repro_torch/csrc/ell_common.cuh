// The ordered spike-id compaction in plain launches, used by
// spike_deliver.cu (K5).  (K2, K3 and K4 in lif_deliver.cu compact in one
// pass by decoupled look-back instead.)
//
// The neurons are cut into one tile per block: each block counts its tile,
// and in a second launch each block sums the counts of the tiles before it
// and writes its spikes' ranks with a block-wide prefix scan, so the ids
// come out ascending, as jnp.nonzero gives them.  Ranks at or past `budget`
// are dropped.
#pragma once

#include "common.cuh"

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
