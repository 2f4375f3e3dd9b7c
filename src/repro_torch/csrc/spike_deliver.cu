// K5: activity-gated dense spike delivery (the `dense` strategy).
//
// Replaces the TPU kernel repro/kernels/spike_deliver.py:
// gated_spike_matvec_pallas (body _kernel, pallas_call at :80), together
// with the einsum, roll and add around it in repro/core/delivery.py:
// deliver_dense.  Per step, for the spiking presynaptic ids p of each
// channel (ch = p >= n_exc, Dale's law):
//
//   upd[d, ch, n] = sum_p W[d, p, n]        (from zero, ascending p, f32)
//   ring[(t + d) % D, ch, n] += upd[d, ch, n]
// where t is the session's step counter, read from device memory (so that a
// launch captured in a CUDA graph reads the counter its replay finds).
//
// The TPU kernel streams W[D, P, N] through VMEM in 512 x 512 tiles and,
// through a scalar-prefetched block map, skips the tiles whose 512-wide
// block of presynaptic spikes is all zero.  At natural rates about 80 % of
// the blocks of 512 hold no spike and are skipped, so it still reads about
// a fifth of W each step.  Here the gate is the presynaptic row itself:
// an ordered compaction of the spiking ids (tile counts and block prefix
// scans, ell_common.cuh, sized to P with no budget: the dense
// strategy has no overflow, and no spike is ever dropped), then one thread
// per output (d, n), coalesced over n, that reads only the spiking rows.
//
// Bound: the spiking rows, S * D * N * sizeof(W) bytes, plus the ring's
// read and write, 2 * D * 2 * N * 4 bytes, plus the [P] spike vector; the
// adds (S * D * N) are far below the float32 rate, so it is memory-bound.
// At scale 0.2 (N = 15,435, D = 46) and 5 spikes a step: 14 MB of rows and
// 11 MB of ring, about 8 us at 3.35 TB/s, against the 43.8 GB of the whole
// table.  No atomics: every output has one thread, which sums in a fixed
// order with every add rounded on its own (__fadd_rn, --fmad=false), so the
// ring equals the plain version's bit for bit.  W's offsets are 64-bit:
// D * P * N passes 2^31 from scale 0.1 on.  The count stays on the device:
// the host never waits.
#include <cuda_bf16.h>

#include <algorithm>

#include "ell_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) count_kernel(
    const unsigned char* __restrict__ spiked, int p, int tile,
    int* __restrict__ counts) {
  __shared__ int smem[32];
  const int lo = min(static_cast<int>(blockIdx.x) * tile, p);
  const int hi = min(lo + tile, p);
  const int c = tile_count(spiked, lo, hi, smem);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// Every spiking id, ascending, into ids[0, total); total into *count.
__global__ void __launch_bounds__(kBlock) write_kernel(
    const unsigned char* __restrict__ spiked, int p, int tile,
    const int* __restrict__ counts, int* __restrict__ ids,
    int* __restrict__ count) {
  __shared__ int smem[32];
  int total;
  const int rank = tiles_before(counts, static_cast<int>(blockIdx.x),
                                static_cast<int>(gridDim.x), smem, &total);
  const int lo = min(static_cast<int>(blockIdx.x) * tile, p);
  const int hi = min(lo + tile, p);
  tile_write(spiked, lo, hi, rank, ids, p, smem);
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = total;
}

__device__ __forceinline__ float as_float(float w) { return w; }
__device__ __forceinline__ float as_float(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

// One thread per output (d = blockIdx.y, column n).  With `out` set (the
// kernel-level gated_spike_matvec, n_exc == P) the one sum is written to
// out[d, n] and `scale` multiplies each row by s[p]; otherwise both
// channels' sums are added into the ring at phase t.
template <typename T>
__global__ void __launch_bounds__(kBlock) rows_kernel(
    const int* __restrict__ ids, const int* __restrict__ count,
    const T* __restrict__ W, const float* __restrict__ scale, int p, int n,
    int n_exc, float* __restrict__ ring, const int* __restrict__ t,
    int d_bins, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int d = blockIdx.y;
  const int total = *count;
  const T* w = W + static_cast<size_t>(d) * p * n + col;
  float acc_ex = 0.0f, acc_in = 0.0f;
#pragma unroll 4
  for (int j = 0; j < total; ++j) {
    const int pre = ids[j];
    float v = as_float(w[static_cast<size_t>(pre) * n]);
    if (scale != nullptr) v = __fmul_rn(scale[pre], v);
    if (pre < n_exc) {
      acc_ex = __fadd_rn(acc_ex, v);
    } else {
      acc_in = __fadd_rn(acc_in, v);
    }
  }
  if (out != nullptr) {
    out[static_cast<size_t>(d) * n + col] = acc_ex;
    return;
  }
  const size_t n_cols = static_cast<size_t>(n) + 1;
  const int phase = (*t % d_bins + d_bins) % d_bins;   // t may be negative
  float* r = ring + static_cast<size_t>((phase + d) % d_bins) * 2 * n_cols +
             col;
  r[0] = __fadd_rn(r[0], acc_ex);
  r[n_cols] = __fadd_rn(r[n_cols], acc_in);
}

}  // namespace

// Tile width of the compaction, one block's width: with no budget to stop
// at, each block scans its whole tile, so many short tiles finish sooner
// than K2's 8-block-wide ones.  The wrapper sizes `counts` to
// ceil(p / spike_compact_tile()).
EXPORT int spike_compact_tile() { return kBlock; }

// spiked [p] bool; counts [ceil(p / tile)], ids [p] and count [1] int32
// scratch; W [d_bins, p, n] float32 (w_bf16 == 0) or bfloat16; scale [p]
// or null; ring [d_bins, 2, n + 1] float32 and t [1] int32 (the step
// counter, on the card), or both null and out [d_bins, n] float32.
EXPORT int gated_spike_launch(const unsigned char* spiked, int p,
                              int* counts, int* ids, int* count,
                              const void* W, int w_bf16, const float* scale,
                              int d_bins, int n, int n_exc, float* ring,
                              const int* t, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = spike_compact_tile();
  const int n_tiles = std::max(1, (p + tile - 1) / tile);
  count_kernel<<<n_tiles, kBlock, 0, st>>>(spiked, p, tile, counts);
  write_kernel<<<n_tiles, kBlock, 0, st>>>(spiked, p, tile, counts, ids,
                                           count);
  const dim3 grid((n + kBlock - 1) / kBlock, d_bins);
  if (w_bf16) {
    rows_kernel<__nv_bfloat16><<<grid, kBlock, 0, st>>>(
        ids, count, static_cast<const __nv_bfloat16*>(W), scale, p, n, n_exc,
        ring, t, d_bins, out);
  } else {
    rows_kernel<float><<<grid, kBlock, 0, st>>>(
        ids, count, static_cast<const float*>(W), scale, p, n, n_exc, ring,
        t, d_bins, out);
  }
  return static_cast<int>(cudaGetLastError());
}
