// pop_counts: a step's spikes counted per population, in one launch.
//
// Replaces no Pallas kernel.  The reference counts a step's spikes per
// population with a sorted segment_sum (repro/api/probes.py:59-65), which
// the JAX package leaves to XLA; the port's plain version is a running
// count differenced at the populations' bounds (kernels/pop_counts.py),
// six PyTorch launches a step on the card.
//
// Population p is the segment [at[p], at[p + 1]) of the [L] bool spike
// vector (pop_of is sorted; L >= at[n_pops], and the sharded backend's
// padding past at[n_pops] is never read).  The work is N bytes read, 77 KB
// at full scale and in L2 just after the step's kernel wrote them: about
// 0.03 us at 3.35 TB/s, so the launch's own latency bounds it, and the
// design's aim is one short launch.  One block per population, so that
// each count is a block's reduction written by one thread: no atomics, no
// memset of the output, no second pass, and the result is exact in any
// order of summation.  Each thread loads up to kUnroll 16-byte vectors of
// the segment's aligned interior at once (PD14's largest population, L4e
// with 21,915 neurons, is one round at 512 threads), and the unaligned
// head and tail, under 16 bytes each, a byte a thread.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

// The number of non-zero bytes of a 32-bit word: a byte's high bit is set
// by the add when its low seven bits are not all 0, or by the or.
__device__ __forceinline__ int nonzero_bytes(unsigned w) {
  const unsigned hi = ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w;
  return __popc(hi & 0x80808080u);
}

__device__ __forceinline__ int nonzero_bytes(const uint4& q) {
  return nonzero_bytes(q.x) + nonzero_bytes(q.y) + nonzero_bytes(q.z) +
         nonzero_bytes(q.w);
}

__global__ void __launch_bounds__(kThreads) pop_counts_kernel(
    const unsigned char* __restrict__ spiked, const int* __restrict__ at,
    int* __restrict__ out) {
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const long long lo = at[p];
  const long long hi = max(static_cast<long long>(at[p + 1]), lo);
  // [a, b): the segment's 16-byte aligned interior; [lo, a) and [b, hi)
  // are under 16 bytes each, or [lo, hi) is all head when no aligned
  // boundary falls inside it
  const long long base = static_cast<long long>(
      reinterpret_cast<uintptr_t>(spiked));
  const long long a = min(((base + lo + 15) & ~15LL) - base, hi);
  const long long b = max(((base + hi) & ~15LL) - base, a);
  int count = 0;
  if (t < a - lo) count += spiked[lo + t] != 0;
  if (t < hi - b) count += spiked[b + t] != 0;
  const uint4* v = reinterpret_cast<const uint4*>(spiked + a);
  const int n_vec = static_cast<int>((b - a) >> 4);
  for (int i0 = t; i0 < n_vec; i0 += kThreads * kUnroll) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      q[u] = i < n_vec ? v[i] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count += nonzero_bytes(q[u]);
  }
  __shared__ int warp_sums[kThreads / 32];
  count = static_cast<int>(
      __reduce_add_sync(0xffffffffu, static_cast<unsigned>(count)));
  if ((t & 31) == 0) warp_sums[t >> 5] = count;
  __syncthreads();
  if (t < 32) {
    const unsigned s = t < kThreads / 32 ? warp_sums[t] : 0;
    const unsigned total = __reduce_add_sync(0xffffffffu, s);
    if (t == 0) out[p] = static_cast<int>(total);
  }
}

}  // namespace

EXPORT int pop_counts_launch(const unsigned char* spiked, const int* at,
                             int* out, int n_pops, void* stream) {
  if (n_pops > 0)
    pop_counts_kernel<<<n_pops, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(spiked, at, out);
  return static_cast<int>(cudaGetLastError());
}
