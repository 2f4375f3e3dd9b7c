// The pair-STDP weight update of one step: the potentiation and the clip
// after K4, or the whole step on the split path and in the fused loop's
// epilogue.
//
// Replaces what the JAX package leaves to XLA, with no Pallas counterpart:
// repro/core/plasticity.py:stdp_pot_clip (:206), which follows the fused
// kernel, and stdp_step (:143) on the split path.  stdp_step orders its ops
// as: [full] depression of the OUT rows of the step's ids (the spiking
// sources), w + (-(dep * x_post[target])) on plastic entries; potentiation
// through the IN rows of the ids (the spiking targets), w + pot *
// x_pre[source], with x_pre from before the step's bump and source =
// syn / K (in_syn indexes the [N+1, K] table); the clip to [0, w_max] of
// the plastic entries it touched (with clip_all: of the whole table); and
// [full] the traces' decay and bump into new buffers.  A synapse whose
// source and target both fired gets (w + dep) + pot, clipped after both.
//
// Here every touched entry has one owner, which computes its final value
// from the weight before the step in one pass, so the step needs no grid
// barrier:
//   * the IN entries of the ids' rows: each synapse has one target and the
//     ids are distinct, so each is reached once.  Its owner depresses it
//     (full, and its source is among the ids), potentiates and clips it;
//   * the plastic OUT entries of the ids' rows whose target is NOT among
//     the ids: depressed (full) and clipped by the OUT pass.  An OUT entry
//     whose target is among the ids is the IN pass's.  "Among the ids" is a
//     binary search in the block's copy of the ids (ascending, then the
//     sentinel N), so a target that spiked but was cut by the budget is
//     the OUT pass's: it is not potentiated, but it is clipped.
// No entry is read by one thread and written by another, and the
// arithmetic is the plain version's op for op (common.cuh), so the result
// equals it bit for bit.  Clipping is idempotent and an untouched weight
// does not change, so one whole-table clip in a run's first update and
// then the touched entries only equals clipping every entry every step.
// The whole-table clip must follow every owner's store: that form alone
// has a grid barrier, and only it is launched cooperatively.
//
// The grid is one block of kBlock threads per SM.  The flat space of the
// ids' OUT entries then IN entries is strided evenly over every thread,
// each with kUnroll entries in flight: the mask, target and weight (OUT) or
// the mask and weight index (IN) in one round trip, then the weight and the
// source's trace (IN) or the target's trace (OUT, full) in a second.
// Bound: the ids' IN rows (index and mask, 5 B an entry), the OUT rows'
// masks, the touched weights read and written and their traces: a few MB a
// step at full scale, so memory-bound; at 25 spikes a step the time is the
// launch and three dependent memory round trips (PERF.md).  The
// whole-table clip reads the mask and the plastic weights once (about
// 2.6 GB at full scale), once a run.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 1024;
constexpr int kUnroll = 4;            // entries a thread has in flight
constexpr int kClipUnroll = 8;        // the same in the whole-table clip
constexpr int kSmemIds = 8192;        // ids a block copies to shared memory
// %globaltimer stamps a block of the stamped launches: its start, and the
// end of each of PHASES in kernels/stdp.py
constexpr int kStamps = 4;

struct StdpConst {                    // the same for every step of a session
  const int* targets;                 // [N+1, k] OUT view
  const unsigned char* pmask;         // [N+1, k] plastic entries
  float* w;                           // [N+1, k], updated in place
  const int* in_syn;                  // [N+1, k_in] entry index into w
  const unsigned char* pmask_in;      // [N+1, k_in]
  int n, k, k_in, budget, grid;
  float dep, pot, decay_p, decay_m, w_max;
};

struct StdpIO {                       // this step's tensors
  const int* ids;                     // [budget], ascending, then N
  const float* x_pre;                 // [N] traces before the step
  const float* x_post;                // (full)
  const unsigned char* spiked;        // [N] the step's spikes (full)
  float* x_pre_o;                     // [N] new buffers (full)
  float* x_post_o;
  unsigned long long* stamps;         // [grid, kStamps], stamped launches
  int full, clip_all;
};

struct StdpArgs {
  StdpConst k;
  StdpIO io;
};

// The first index of ids[0, len) (ascending) whose id is >= x.
__device__ __forceinline__ int lower_bound(const int* ids, int len, int x) {
  int lo = 0;
  while (len > 0) {
    const int half = len >> 1;
    if (ids[lo + half] < x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

__device__ __forceinline__ bool among(const int* ids, int n_real, int x) {
  const int i = lower_bound(ids, n_real, x);
  return i < n_real && ids[i] == x;
}

template <bool kStamped>
__global__ void __launch_bounds__(kBlock, 1) stdp_update_kernel(StdpArgs a) {
  const StdpConst& k = a.k;
  const StdpIO& io = a.io;
  __shared__ int s_ids[kSmemIds];
  const int g = blockIdx.x * kBlock + threadIdx.x, threads = gridDim.x * kBlock;
  stamp<kStamps, kStamped>(io.stamps, 0);
  // this thread's first neuron's trace inputs, in flight with the ids
  const bool trace = io.full && g < k.n;
  float xp0 = 0.0f, xq0 = 0.0f;
  unsigned char sp0 = 0;
  if (trace) {
    xp0 = io.x_pre[g];
    xq0 = io.x_post[g];
    sp0 = io.spiked[g];
  }
  for (int i = threadIdx.x; i < min(k.budget, kSmemIds); i += kBlock)
    s_ids[i] = io.ids[i];
  __syncthreads();
  const int* ids = k.budget <= kSmemIds ? s_ids : io.ids;
  const int n_real = lower_bound(ids, k.budget, k.n);
  stamp<kStamps, kStamped>(io.stamps, 1);

  if (trace) {
    io.x_pre_o[g] = stdp_trace(xp0, k.decay_p, sp0);
    io.x_post_o[g] = stdp_trace(xq0, k.decay_m, sp0);
    for (int i = g + threads; i < k.n; i += threads) {
      io.x_pre_o[i] = stdp_trace(io.x_pre[i], k.decay_p, io.spiked[i]);
      io.x_post_o[i] = stdp_trace(io.x_post[i], k.decay_m, io.spiked[i]);
    }
  }

  // the ids' OUT entries [0, n_out), then their IN entries [n_out, total);
  // both < 2^30 (the wrapper checks)
  const int n_out = n_real * k.k, total = n_out + n_real * k.k_in;
  for (int e0 = g; e0 < total; e0 += kUnroll * threads) {
    int at[kUnroll], tg[kUnroll];     // OUT: entry, target; IN: syn, source
    float w[kUnroll], xq[kUnroll], xp[kUnroll];
    bool own[kUnroll], in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * threads;
      own[u] = false;
      in[u] = e >= n_out;
      if (e < n_out) {
        const int r = e / k.k;
        at[u] = ids[r] * k.k + (e - r * k.k);
        own[u] = k.pmask[at[u]] != 0;
        tg[u] = k.targets[at[u]];
        w[u] = k.w[at[u]];
      } else if (e < total) {
        const int f = e - n_out, r = f / k.k_in;
        const int t = ids[r];
        const int ai = t * k.k_in + (f - r * k.k_in);
        own[u] = k.pmask_in[ai] != 0;
        at[u] = k.in_syn[ai];
        if (io.full) xq[u] = io.x_post[t];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!own[u]) continue;
      if (in[u]) {
        tg[u] = at[u] / k.k;
        w[u] = k.w[at[u]];
        xp[u] = io.x_pre[tg[u]];
      } else if (among(ids, n_real, tg[u])) {
        own[u] = false;               // the target's IN entry owns it
      } else if (io.full) {
        xq[u] = io.x_post[tg[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!own[u]) continue;
      float v = w[u];
      if (io.full && (!in[u] || among(ids, n_real, tg[u])))
        v = stdp_depressed(v, k.dep, xq[u]);
      if (in[u]) v = stdp_potentiated(v, k.pot, xp[u]);
      v = stdp_clipped(v, k.w_max);
      if (__float_as_uint(v) != __float_as_uint(w[u])) k.w[at[u]] = v;
    }
  }
  stamp<kStamps, kStamped>(io.stamps, 2);

  if (io.clip_all) {                  // cooperative launches only
    cg::this_grid().sync();
    // a stream over the whole table: kClipUnroll masks, then their
    // weights, in flight a thread
    const size_t all = static_cast<size_t>(k.n + 1) * k.k;
    for (size_t e0 = g; e0 < all; e0 += kClipUnroll * threads) {
      bool m[kClipUnroll];
      float v[kClipUnroll];
#pragma unroll
      for (int u = 0; u < kClipUnroll; ++u) {
        const size_t e = e0 + static_cast<size_t>(u) * threads;
        m[u] = e < all && k.pmask[e];
      }
#pragma unroll
      for (int u = 0; u < kClipUnroll; ++u)
        if (m[u]) v[u] = k.w[e0 + static_cast<size_t>(u) * threads];
#pragma unroll
      for (int u = 0; u < kClipUnroll; ++u) {
        if (!m[u]) continue;
        const float c = stdp_clipped(v[u], k.w_max);
        if (__float_as_uint(c) != __float_as_uint(v[u]))
          k.w[e0 + static_cast<size_t>(u) * threads] = c;
      }
    }
  }
  stamp<kStamps, kStamped>(io.stamps, 3);
}

template <bool kStamped>
int launch(const StdpConst* k, const StdpIO& io, void* stream) {
  StdpArgs a{*k, io};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k->grid);
  cfg.blockDim = dim3(kBlock);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = io.clip_all ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, stdp_update_kernel<kStamped>, a);
  // cudaGetLastError() also clears a refused launch's error, so the next
  // launch does not report it as its own.
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// The grid on this card: one block per SM.  Returns -1 when the card has
// no cooperative launch (the whole-table clip needs one), -2 when a block
// does not fit on an SM.
EXPORT int stdp_update_grid(int* grid_out) {
  int dev = 0, coop = 0, sms = 0, fit = 0, fit_st = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, stdp_update_kernel<false>, kBlock, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit_st, stdp_update_kernel<true>, kBlock, 0);
  if (fit < 1 || fit_st < 1) return -2;
  *grid_out = sms;
  return static_cast<int>(cudaGetLastError());
}

// sizeof(StdpConst), which the wrapper's ctypes mirror must equal; the
// stamps a block writes.
EXPORT int stdp_update_const_bytes() { return sizeof(StdpConst); }
EXPORT int stdp_update_stamps() { return kStamps; }

#define STDP_IO_PARAMS                                                      \
  const int *ids, const float *x_pre, const float *x_post,                  \
      const unsigned char *spiked, float *x_pre_o, float *x_post_o,         \
      int full, int clip_all

#define STDP_IO                                                             \
  StdpIO io{ids,      x_pre,   x_post, spiked, x_pre_o,                     \
            x_post_o, nullptr, full,   clip_all}

// `k` is the session's constant pack (tables, sizes, coefficients, grid),
// built once by the wrapper; x_post, spiked and the new buffers are read
// and written only with `full`.
EXPORT int stdp_update_launch(const StdpConst* k, STDP_IO_PARAMS,
                              void* stream) {
  STDP_IO;
  return launch<false>(k, io, stream);
}

// The stamped instantiation, for chip_smoke.py's phase table: each block
// writes its kStamps %globaltimer stamps into stamps[blockIdx.x * kStamps].
EXPORT int stdp_update_stamped_launch(const StdpConst* k, STDP_IO_PARAMS,
                                      unsigned long long* stamps,
                                      void* stream) {
  STDP_IO;
  io.stamps = stamps;
  return launch<true>(k, io, stream);
}
