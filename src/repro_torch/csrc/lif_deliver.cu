// K3 and K4: the fused one-kernel simulation step, static and plastic.
//
// K3 replaces the TPU kernel repro/kernels/lif_deliver.py:
// lif_deliver_pallas (body _kernel_static :120, _deliver_row :73,
// _lif_phase :97; pallas_call at :244), K4 its plastic twin
// lif_deliver_plastic_pallas (body _kernel_plastic :145-190; pallas_call
// at :316).  Both are one template, lif_deliver_kernel<kPlastic>, so the
// compaction and the LIF phase exist once.  One launch per step: deliver
// the previous step's spikes at ring phase t_prev, then integrate step
// t_prev + 1 against ring slot (t_prev + 1) % D and consume that slot.
//
// On the TPU the grid runs in order on one core, so the LIF update can
// simply be the last grid row.  Hopper's blocks run in parallel and in no
// order, so the phases are separated by grid-wide barriers: the kernel is
// launched cooperatively (cudaLaunchCooperativeKernel) with a grid no
// larger than the co-resident block count, and cg::this_grid().sync()
// orders
//   1. ordered compaction of spiked_prev: count per tile | sync |
//      ranked ids, fill, overflow                              | sync |
//   2. scatter of the real ids' rows at phase t_prev; K4 writes each
//      plastic entry back depressed, w + (-(dep_coef * x_post[target])),
//      after scattering the weight it read                     | sync |
//   3. LIF update of every neuron against slot (t_prev+1) % D, zeroing
//      both channel rows of that slot (the dump column included), and
//      the new spike vector; K4 also decays the pair-STDP traces and bumps
//      them with spiked_prev (x * decay + spike) into NEW buffers: the
//      depression above read the old x_post, and the potentiation that
//      follows (stdp_update.cu) reads the old x_pre.
// There is no VMEM-style residency cap: the ring ([D, 2, N+1] f32, 28 MB
// at full scale) is updated in place in device memory and stays in L2,
// and K4's weights are the live table itself, updated in place (each entry
// is read and written by one thread, so there is no race).  K4 leaves the
// potentiation and the clip to stdp_update.cu, which takes the ids K4
// wrote.  Bound: K1's 45 B per neuron, the consumed slot, and K2's
// spiking rows (about 6.4 MB per step at full scale); K4 adds the rows'
// plastic mask, the depressed entries' write-back and 20 B of traces per
// neuron; memory-bound.  If the card refuses the cooperative launch the
// wrapper raises; it never falls back to K2 + K1.
#include <cooperative_groups.h>

#include <algorithm>

#include "ell_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 512;

struct PlasticArgs {                  // K4 only
  Depression dep;                     // weights = the live table
  const float* x_pre;                 // [N] traces before this step
  float* x_pre_o;                     // [N] new buffers
  float* x_post_o;
  float decay_p, decay_m;
  int trace;   // 0 in the rotated loop's first step: no spikes were
               // delivered, and the traces must not decay an extra step
};

struct StepArgs {
  const unsigned char* spiked_prev;   // [N]
  EllTables tb;
  float* ring;                        // [D, 2, N+1], updated in place
  const float* V;
  const float* I_ex;
  const float* I_in;
  const int* refrac;
  const float* ext_ex;                // [N] external input, pre-scaled
  const float* i_dc;                  // [N]
  float* Vo;
  float* Iexo;
  float* Iino;
  int* refo;
  unsigned char* spk;                 // [N] this step's spikes
  int* counts;                        // [gridDim.x] scratch
  int* ids;                           // [budget] delivered ids
  int* overflow;                      // [1] budget excess of spiked_prev
  int n, n_exc, d_bins, budget, t_prev;
  LifProp p;
  PlasticArgs pl;
};

template <bool kPlastic>
__global__ void __launch_bounds__(kBlock) lif_deliver_kernel(StepArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int smem[32];
  const int n_cols = a.n + 1;

  // 1. ordered compaction of the previous step's spikes
  const int n_tiles = static_cast<int>(gridDim.x);
  const int tile = (a.n + n_tiles - 1) / n_tiles;
  const int lo = min(static_cast<int>(blockIdx.x) * tile, a.n);
  const int hi = min(lo + tile, a.n);
  const int c = tile_count(a.spiked_prev, lo, hi, smem);
  if (threadIdx.x == 0) a.counts[blockIdx.x] = c;
  grid.sync();
  int total;
  const int rank = tiles_before(a.counts, static_cast<int>(blockIdx.x),
                                static_cast<int>(gridDim.x), smem, &total);
  if (rank < a.budget)
    tile_write(a.spiked_prev, lo, hi, rank, a.ids, a.budget, smem);
  compact_tail(total, a.ids, a.budget, a.n, a.overflow);
  grid.sync();

  // 2. scatter: (id, chunk) work items of the real ids only
  const int n_real = min(total, a.budget);
  const int chunks = (a.tb.k_pad + kScatterChunk - 1) / kScatterChunk;
  for (int w = blockIdx.x; w < n_real * chunks; w += gridDim.x) {
    const int s = w / chunks, j0 = (w % chunks) * kScatterChunk;
    scatter_chunk<kPlastic>(a.tb, a.ids[s], j0,
                            min(j0 + kScatterChunk, a.tb.k_pad), a.ring,
                            a.t_prev, a.d_bins, n_cols, a.n_exc, a.pl.dep);
  }
  grid.sync();

  // 3. LIF update against the just-delivered slot, which it then consumes
  const int slot = (a.t_prev + 1) % a.d_bins;
  float* row_ex = a.ring + static_cast<size_t>(slot) * 2 * n_cols;
  float* row_in = row_ex + n_cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_cols;
       i += gridDim.x * blockDim.x) {
    if (i < a.n) {
      const float in_ex = __fadd_rn(row_ex[i], a.ext_ex[i]);
      lif_neuron(a.p, a.V[i], a.I_ex[i], a.I_in[i], a.refrac[i], in_ex,
                 row_in[i], a.i_dc[i], a.Vo + i, a.Iexo + i, a.Iino + i,
                 a.refo + i, a.spk + i);
      if (kPlastic && a.pl.trace) {
        const unsigned char sp = a.spiked_prev[i];
        a.pl.x_pre_o[i] = stdp_trace(a.pl.x_pre[i], a.pl.decay_p, sp);
        a.pl.x_post_o[i] = stdp_trace(a.pl.dep.x_post[i], a.pl.decay_m, sp);
      }
    }
    row_ex[i] = 0.0f;
    row_in[i] = 0.0f;
  }
}

template <bool kPlastic>
int cooperative_grid(int n_cols, int* grid_out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lif_deliver_kernel<kPlastic>, kBlock, 0);
  const int want = (n_cols + kBlock - 1) / kBlock;
  *grid_out = std::min(per_sm * sms, want);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPlastic>
int launch(StepArgs& a, int grid, void* stream) {
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lif_deliver_kernel<kPlastic>), dim3(grid),
      dim3(kBlock), args, 0, static_cast<cudaStream_t>(stream));
  // cudaGetLastError() also clears a refused launch's error, so the next
  // launch does not report it as its own.
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// The cooperative grid of K3 (plastic = 0) or K4 for this card:
// co-resident blocks per SM x SMs, capped at one block per kBlock ring
// columns.  Returns -1 when the card has no cooperative launch.
EXPORT int lif_deliver_grid(int n_cols, int plastic, int* grid_out) {
  return plastic ? cooperative_grid<true>(n_cols, grid_out)
                 : cooperative_grid<false>(n_cols, grid_out);
}

#define STEP_PARAMS                                                         \
  const unsigned char *spiked_prev, const int *targets, float *weights,     \
      const int *dbins, int k_pad, float *ring, const float *V,             \
      const float *I_ex, const float *I_in, const int *refrac,              \
      const float *ext_ex, const float *i_dc, float *Vo, float *Iexo,       \
      float *Iino, int *refo, unsigned char *spk, int *counts, int *ids,    \
      int *overflow, int n, int n_exc, int d_bins, int budget, int t_prev,  \
      float P11_ex, float P11_in, float P22, float P21_ex, float P21_in,    \
      float P20, float V_th, float V_reset, float E_L, int ref_steps,       \
      int grid

#define STEP_ARGS                                                           \
  StepArgs a{spiked_prev, EllTables{targets, weights, dbins, k_pad},        \
             ring, V, I_ex, I_in, refrac, ext_ex, i_dc, Vo, Iexo, Iino,     \
             refo, spk, counts, ids, overflow, n, n_exc, d_bins, budget,    \
             t_prev,                                                        \
             LifProp{P11_ex, P11_in, P22, P21_ex, P21_in, P20, V_th,        \
                     V_reset, E_L, ref_steps}}

EXPORT int lif_deliver_launch(STEP_PARAMS, void* stream) {
  STEP_ARGS;
  return launch<false>(a, grid, stream);
}

// K4: K3's arguments (weights: the live table, updated in place), then the
// plastic mask, the traces before the step, their new buffers and the
// pair-STDP immediates.
EXPORT int lif_deliver_plastic_launch(
    STEP_PARAMS, const unsigned char* pmask, const float* x_pre,
    const float* x_post, float* x_pre_o, float* x_post_o, float dep_coef,
    float decay_p, float decay_m, int trace, void* stream) {
  STEP_ARGS;
  a.pl = PlasticArgs{Depression{weights, pmask, x_post, dep_coef}, x_pre,
                     x_pre_o, x_post_o, decay_p, decay_m, trace};
  return launch<true>(a, grid, stream);
}
