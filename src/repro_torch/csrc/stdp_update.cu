// The pair-STDP weight update of one step: the potentiation and the clip
// after K4, or the whole step on the split path and in the fused loop's
// epilogue.
//
// Replaces what the JAX package leaves to XLA, with no Pallas counterpart:
// repro/core/plasticity.py:stdp_pot_clip (:206), which follows the fused
// kernel, and stdp_step (:143) on the split path.  One cooperative launch;
// grid barriers order the phases as stdp_step orders its ops:
//   [full] depression of the OUT rows of the step's ids (the spiking
//          sources): w + (-(dep * x_post[target])) on plastic entries,
//          and the traces' decay and bump into new buffers     | sync |
//   potentiation through the IN rows of the ids (the spiking targets):
//          w + pot * x_pre[source], with x_pre from before the step's
//          bump and source = syn / K (in_syn indexes the [N+1, K]
//          table)                                              | sync |
//   the clip to [0, w_max] of the plastic entries the step touched: those
//          of the ids' OUT rows and IN rows (with clip_all: of the whole
//          table).
// A synapse whose source and target both fired gets (w + dep) + pot and is
// clipped only after both, as in stdp_step.  Each synapse has one target,
// so for distinct ids every potentiation hits its own entry: plain stores,
// no atomics, and the result equals the plain version bit for bit.  (An
// entry in both an OUT and an IN row may be clipped by two threads; both
// store the same value.)  Clipping is idempotent and an untouched weight
// does not change, so one whole-table clip in a run's first update and then
// the touched entries only equals clipping every entry every step.
// Bound: the ids' IN rows (index and mask, 5 B an entry), the touched
// weights read and written, and the OUT rows' mask for the clip: a few MB
// a step at full scale, so memory-bound; the whole-table clip reads the
// mask and the plastic weights once (about 2.6 GB at full scale), once a
// run.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 512;
constexpr int kChunk = 1024;          // row entries per work item

struct StdpArgs {
  const int* ids;                     // [budget], ascending, then N
  const int* targets;                 // [N+1, k] OUT view
  const unsigned char* pmask;         // [N+1, k] plastic entries
  float* w;                           // [N+1, k], updated in place
  const int* in_syn;                  // [N+1, k_in] entry index into w
  const unsigned char* pmask_in;      // [N+1, k_in]
  const float* x_pre;                 // [N] traces before the step
  const float* x_post;
  const unsigned char* spiked;        // [N] the step's spikes (full)
  float* x_pre_o;                     // [N] new buffers (full)
  float* x_post_o;
  int n, k, k_in, budget, full, clip_all;
  float dep, pot, decay_p, decay_m, w_max;
};

// Calls f(e) for every entry e of the rows of the real ids (row length
// `len`), one (id, chunk) work item per block, the threads striding over
// the chunk.
template <typename F>
__device__ __forceinline__ void for_rows(const StdpArgs& a, int len, F f) {
  const int chunks = (len + kChunk - 1) / kChunk;
  for (int item = blockIdx.x; item < a.budget * chunks; item += gridDim.x) {
    const int id = a.ids[item / chunks];
    if (id >= a.n) continue;          // the sentinel fill
    const int j0 = (item % chunks) * kChunk, j1 = min(j0 + kChunk, len);
    const size_t row = static_cast<size_t>(id) * len;
    for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) f(row + j);
  }
}

__device__ __forceinline__ void clip_entry(float* w, size_t e, float w_max) {
  const float v = w[e], c = stdp_clipped(v, w_max);
  if (__float_as_uint(c) != __float_as_uint(v)) w[e] = c;
}

__global__ void __launch_bounds__(kBlock) stdp_update_kernel(StdpArgs a) {
  cg::grid_group grid = cg::this_grid();
  if (a.full) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
         i += gridDim.x * blockDim.x) {
      a.x_pre_o[i] = stdp_trace(a.x_pre[i], a.decay_p, a.spiked[i]);
      a.x_post_o[i] = stdp_trace(a.x_post[i], a.decay_m, a.spiked[i]);
    }
    for_rows(a, a.k, [=](size_t e) {
      if (a.pmask[e])
        a.w[e] = stdp_depressed(a.w[e], a.dep, a.x_post[a.targets[e]]);
    });
    grid.sync();
  }
  for_rows(a, a.k_in, [=](size_t e) {
    if (a.pmask_in[e]) {
      const int syn = a.in_syn[e];
      a.w[syn] = stdp_potentiated(a.w[syn], a.pot, a.x_pre[syn / a.k]);
    }
  });
  grid.sync();
  if (a.clip_all) {
    const size_t total = static_cast<size_t>(a.n + 1) * a.k;
    for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
         e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x)
      if (a.pmask[e]) clip_entry(a.w, e, a.w_max);
  } else {
    for_rows(a, a.k, [=](size_t e) {
      if (a.pmask[e]) clip_entry(a.w, e, a.w_max);
    });
    for_rows(a, a.k_in, [=](size_t e) {
      if (a.pmask_in[e]) clip_entry(a.w, a.in_syn[e], a.w_max);
    });
  }
}

}  // namespace

// The cooperative grid for this card: co-resident blocks per SM x SMs.
// Returns -1 when the card has no cooperative launch.
EXPORT int stdp_update_grid(int* grid_out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stdp_update_kernel,
                                                kBlock, 0);
  *grid_out = per_sm * sms;
  return static_cast<int>(cudaGetLastError());
}

EXPORT int stdp_update_launch(
    const int* ids, int budget, const int* targets,
    const unsigned char* pmask, float* w, int k, const int* in_syn,
    const unsigned char* pmask_in, int k_in, const float* x_pre,
    const float* x_post, const unsigned char* spiked, float* x_pre_o,
    float* x_post_o, int n, int full, int clip_all, float dep, float pot,
    float decay_p, float decay_m, float w_max, int grid, void* stream) {
  StdpArgs a{ids,    targets, pmask,    w,       in_syn,   pmask_in,
             x_pre,  x_post,  spiked,   x_pre_o, x_post_o, n,
             k,      k_in,    budget,   full,    clip_all, dep,
             pot,    decay_p, decay_m,  w_max};
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(stdp_update_kernel), dim3(grid), dim3(kBlock),
      args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}
