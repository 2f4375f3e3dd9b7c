// K3 and K4: the fused one-kernel simulation step, static and plastic;
// and K2: the spike delivery alone.
//
// K3 replaces the TPU kernel repro/kernels/lif_deliver.py:
// lif_deliver_pallas (body _kernel_static :120, _deliver_row :73,
// _lif_phase :97; pallas_call at :244), K4 its plastic twin
// lif_deliver_plastic_pallas (body _kernel_plastic :145-190; pallas_call
// at :316), K2 repro/kernels/ell_deliver.py:ell_deliver_pallas (body
// _kernel, pallas_call at :110) with the jnp.nonzero compaction of
// repro/kernels/ops.py:54-55.  All three are one template,
// lif_deliver_kernel<Form>, so the compaction, the scatter and the LIF
// phase exist once.  One launch per step: deliver the previous step's
// spikes at ring phase t_prev, then integrate step t_prev + 1 against ring
// slot (t_prev + 1) % D and consume that slot; K2 stops after the delivery
// (its t_prev is the step t it delivers at).
// The ring has n_tgt + 1 columns: targets 0..n_tgt-1 and the dump column
// n_tgt, which the padding entries name.  K3 and K4 take n_tgt == n (the
// ring of the neurons they integrate); K2's local-ring form, the sharded
// step's delivery, compacts a spike vector of all n neurons of the world
// through the rows of its rank's column block, whose targets are that
// rank's n_tgt neurons (repro_torch/core/distributed.py).
// The step counter t is read from device memory, the session's 0-d int32
// counter: K3 and K4 take t_prev = *t - 1, K2 t_prev = *t.  No form writes
// the counter it reads: K3 and K4 write t + 1 into a fresh 0-d output
// (t_next), and the running overflow plus this launch's excess into
// another, so no block can read a value another block has already
// advanced, and a launch captured in a CUDA graph reads the counter its
// replay finds.  K2 writes the excess alone, and the split loop adds it.
// K3 and K4 also take the step's external drive as it is drawn: the float
// spike counts (or none) and the weight w_ext, whose product each neuron
// forms as one rounded multiply, as PyTorch's scalar product does.
//
// On the TPU the grid runs in order on one core, so the LIF update can
// simply be the last grid row, and K2's scatter goes to a ring update held
// in VMEM, which caps the ring's size.  Hopper's blocks run in parallel and
// in no order.  Here one block of kBlock threads runs on each SM (the grid
// is sized for the card, not for N), launched cooperatively so that every
// block is resident and cg::this_grid().sync() can order the phases:
//   1. ordered compaction of spiked_prev in one pass: the lowest `budget`
//      spiking ids ascending, as jnp.nonzero(size=budget) gives them (which
//      spikes an overflow drops is part of the result, so an atomic counter
//      would not do).  The neurons are cut into one tile per block; a block
//      counts its tile, publishes the count, and finds the spikes before its
//      tile by decoupled look-back (its first warp reads its predecessors'
//      published words, up to kLookBack windows of 32 at once, back to the
//      nearest one that holds an inclusive prefix), then publishes its own
//      inclusive prefix and writes its spikes' ids at their ranks below
//      `budget`;                                              | sync |
//   2. the fill (ids[total:budget] = N), the overflow, and the scatter of
//      the real ids' rows at phase t_prev: the flat n_real x k_pad entry
//      space is strided evenly over every thread of the grid, each thread
//      loading kUnroll entries before it adds any (float atomics into the
//      ring, ch = sid >= n_exc by Dale's law, padding skipped); K4 writes
//      each plastic entry back depressed, w + (-(dep_coef *
//      x_post[target])), after scattering the weight it read.  K2 ends
//      here;                                                  | sync |
//   3. LIF update of every neuron against slot (t_prev+1) % D, zeroing
//      both channel rows of that slot (the dump column included), and
//      the new spike vector; K4 also decays the pair-STDP traces and bumps
//      them with spiked_prev (x * decay + spike) into NEW buffers: the
//      depression above read the old x_post, and the potentiation that
//      follows (stdp_update.cu) reads the old x_pre.
// The second sync is the one the semantics need: entries with dbin = 1
// land in the slot that the LIF pass reads and zeroes.  The first one
// feeds the even split, which needs every block's ids.  (A hand-written
// barrier, one counter by red.release / ld.acquire, measured no faster
// than grid.sync() on an H100; PERF.md.)  Float atomics add in no fixed
// order, so the ring agrees with the plain version to a tolerance; ids,
// overflow, spikes, V and refrac are exact.
//
// The look-back words live in a workspace that persists across launches
// of all three forms (the wrapper keeps one per device and grid, zeroed
// once): [0] the launch count (the epoch), [1 + b] block b's word,
// (epoch tag << 2 | kind) << 32 | value.  Every word read is checked
// against this launch's epoch, so no pass resets them; the kernel itself
// advances the epoch once every block has read it (after the first sync),
// never the host, so a replayed CUDA graph stays right.  The look-back's
// spin counts its rounds and traps past kSpinLimit, so a fault ends as a
// CUDA error that the wrapper raises rather than as a hang.
//
// There is no VMEM-style residency cap: the ring ([D, 2, N+1] f32, 28 MB
// at full scale) is updated in place in device memory and stays in L2,
// and K4's weights are the live table itself, updated in place (each entry
// is read and written by one thread, so there is no race).  K4 leaves the
// potentiation and the clip to stdp_update.cu, which takes the ids K4
// wrote.  Bound: K1's 45 B per neuron, the consumed slot, and K2's
// spiking rows (about 6.4 MB per step at full scale; K2 alone: the spike
// vector and the rows, about 2 MB); K4 adds the rows' plastic mask, the
// depressed entries' write-back and 20 B of traces per neuron;
// memory-bound.  At 25 spikes a step the time is not the bytes but a chain
// of memory round trips and the syncs (PERF.md's phase tables).  If the
// card refuses the cooperative launch the wrapper raises; it never falls
// back to K2 + K1.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr int kUnroll = 4;            // scatter entries a thread has in flight
constexpr int kLookBack = 5;          // look-back windows of 32 a round
// ring columns a block takes at least: a smaller network gets fewer
// blocks, since more would only add arrivals at each sync
constexpr int kMinColumns = 256;
// look-back rounds before a trap: seconds, at one L2 round trip a round
constexpr long long kSpinLimit = 1ll << 22;
// %globaltimer stamps a block of the stamped launches: its start, and the
// end of each of PHASES in kernels/lif_deliver.py
constexpr int kStamps = 8;
constexpr unsigned kAggregate = 1, kPrefix = 2;   // a look-back word's kind
constexpr unsigned kFull = 0xffffffffu;

// The kernel's three forms: K3, K4, and K2 (phases 1 and 2 alone).
enum class Form { kStep, kPlasticStep, kDeliver };

struct StepConst {                    // the same for every step of a session
  const int* targets;                 // [N+1, k_pad], sentinel n_tgt
  float* weights;                     // [N+1, k_pad]; K4: the live table
  const int* dbins;                   // [N+1, k_pad], >= 1
  const unsigned char* pmask;         // K4: [N+1, k_pad] plastic entries
  unsigned long long* ws;             // [1 + grid] workspace (see above)
  int k_pad, n, n_tgt, n_exc, d_bins, budget, grid;
  LifProp p;
  float dep_coef, decay_p, decay_m;   // K4's pair-STDP immediates
  float w_ext;                        // K3/K4: the external spikes' weight
};

struct StepIO {                       // this step's tensors
  const unsigned char* spiked_prev;   // [N]
  float* ring;                        // [D, 2, n_tgt+1], in place
  const float* V;
  const float* I_ex;
  const float* I_in;
  const int* refrac;
  const float* ext_cnt;               // [N] external spike counts, or
                                      // null: no stimulus feeds spikes
  const float* i_dc;                  // [N]
  float* Vo;
  float* Iexo;
  float* Iino;
  int* refo;
  unsigned char* spk;                 // [N] this step's spikes
  int* ids;                           // [budget] delivered ids
  int* overflow;                      // [1] budget excess of spiked_prev
  const float* x_pre;                 // K4: [N] traces before this step
  const float* x_post;
  float* x_pre_o;                     // K4: [N] new buffers
  float* x_post_o;
  unsigned long long* stamps;         // [grid, kStamps], stamped launches
  const int* t;                       // [1] the step counter, on the card
  int t_shift;                        // t_prev = *t + t_shift: K3/K4 -1, K2 0
  int trace;   // K4: 0 in the rotated loop's first step: no spikes were
               // delivered, and the traces must not decay an extra step
  const int* overflow_in;             // K3/K4: [1] the running overflow
  int* t_next;                        // K3/K4: [1] *t + 1
};

struct StepArgs {
  StepConst k;
  StepIO io;
};

// One neuron's inputs to the LIF pass, other than its ring slot, loaded
// together before any of its outputs is stored; ext_ex is w_ext times its
// external spike count (read only when there are counts).
struct Neuron {
  float V, I_ex, I_in, ext_ex, i_dc, x_pre, x_post;
  int refrac;
  unsigned char spiked_prev;
};

template <bool kPlastic>
__device__ __forceinline__ Neuron load_neuron(const StepConst& k,
                                              const StepIO& io, int i) {
  Neuron x;
  x.V = io.V[i];
  x.I_ex = io.I_ex[i];
  x.I_in = io.I_in[i];
  x.ext_ex = io.ext_cnt ? __fmul_rn(k.w_ext, io.ext_cnt[i]) : 0.0f;
  x.i_dc = io.i_dc[i];
  x.refrac = io.refrac[i];
  if (kPlastic && io.trace) {
    x.spiked_prev = io.spiked_prev[i];
    x.x_pre = io.x_pre[i];
    x.x_post = io.x_post[i];
  }
  return x;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long word(unsigned tag,
                                                   unsigned kind, int v) {
  return (static_cast<unsigned long long>(tag << 2 | kind) << 32) |
         static_cast<unsigned>(v);
}

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// This block's first rank: the spikes of the tiles before it, by
// decoupled look-back over the words of blocks b-1, b-2, ...  Run by one
// warp.  Each round loads kLookBack windows of 32 words at once (lane l of
// window r reads block j - 32 r - l), then takes them nearest first up to
// the nearest inclusive prefix; a window with a word not yet published
// ends the round, and the next round starts at that window.
__device__ __forceinline__ int look_back(const unsigned long long* words,
                                         int b, unsigned tag) {
  const int lane = threadIdx.x & 31;
  int before = 0;
  long long spins = 0;
  for (int j = b - 1; j >= 0;) {
    unsigned long long w[kLookBack];
#pragma unroll
    for (int r = 0; r < kLookBack; ++r) {
      const int idx = j - 32 * r - lane;
      w[r] = idx >= 0 ? ld_relaxed(words + idx) : word(tag, kPrefix, 0);
    }
    bool found = false;
#pragma unroll
    for (int r = 0; r < kLookBack; ++r) {
      const unsigned head = static_cast<unsigned>(w[r] >> 32);
      if (__any_sync(kFull, (head >> 2) != tag || (head & 3u) == 0)) break;
      const unsigned prefix = __ballot_sync(kFull, (head & 3u) == kPrefix);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;
      before += warp_sum(lane <= stop ? static_cast<int>(w[r] & 0xffffffffu)
                                      : 0);
      found = prefix != 0;
      if (found) break;
      j -= 32;
    }
    if (found) break;
    if (++spins > kSpinLimit) __trap();
  }
  return before;
}

template <Form kForm, bool kStamped>
__global__ void __launch_bounds__(kBlock, 1) lif_deliver_kernel(StepArgs a) {
  constexpr bool kPlastic = kForm == Form::kPlasticStep;
  const StepConst& k = a.k;
  const StepIO& io = a.io;
  __shared__ int warp_total[kWarps];
  __shared__ int tile_first;          // this tile's first rank
  __shared__ unsigned long long launch_no;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  const int n = k.n, n_tgt = k.n_tgt, n_cols = n_tgt + 1;
  unsigned long long* words = k.ws + 1;
  cg::grid_group grid = cg::this_grid();
  const int g = b * kBlock + threadIdx.x, threads = G * kBlock;
  const int t_prev = *io.t + io.t_shift;
  stamp<kStamps, kStamped>(io.stamps, 0);
  if (threadIdx.x == 0) launch_no = ld_relaxed(k.ws);

  // 1. ordered compaction.  Tile b is [lo, hi); each thread counts a
  // contiguous run of it, so that ranks follow neuron order.
  const int tile = (n + G - 1) / G;
  const int lo = min(b * tile, n), hi = min(lo + tile, n);
  const int per = (tile + kBlock - 1) / kBlock;
  const int r0 = min(lo + static_cast<int>(threadIdx.x) * per, hi);
  const int r1 = min(r0 + per, hi);
  int c = 0;
  for (int i = r0; i < r1; ++i) c += io.spiked_prev[i] != 0;
  const int incl = warp_inclusive_scan(c);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  const int wt = lane < kWarps ? warp_total[lane] : 0;
  const int wincl = warp_inclusive_scan(wt);
  const int in_tile = __shfl_sync(kFull, wincl - wt, warp) + incl - c;
  const int count = __shfl_sync(kFull, wincl, 31);
  const unsigned tag = static_cast<unsigned>(launch_no) & 0x3fffffffu;
  stamp<kStamps, kStamped>(io.stamps, 1);
  if (warp == 0) {
    if (lane == 0)
      st_relaxed(words + b, word(tag, b == 0 ? kPrefix : kAggregate, count));
    const int before = look_back(words, b, tag);
    if (lane == 0) {
      if (b > 0) st_relaxed(words + b, word(tag, kPrefix, before + count));
      tile_first = before;
    }
  }
  __syncthreads();
  stamp<kStamps, kStamped>(io.stamps, 2);
  int rank = tile_first + in_tile;
  for (int i = r0; i < r1 && rank < k.budget; ++i)
    if (io.spiked_prev[i]) io.ids[rank++] = i;
  stamp<kStamps, kStamped>(io.stamps, 3);
  grid.sync();
  stamp<kStamps, kStamped>(io.stamps, 4);
  // every block read the epoch before the sync
  if (g == 0) k.ws[0] = launch_no + 1;

  // 2. the fill, the overflow and the scatter, split by entries
  const int total = static_cast<int>(ld_relaxed(words + G - 1) & 0xffffffffu);
  const int n_real = min(total, k.budget);
  for (int p = total + g; p < k.budget; p += threads) io.ids[p] = n;
  if (g == 0) {
    const int excess = max(total - k.budget, 0);
    *io.overflow = io.overflow_in ? *io.overflow_in + excess : excess;
    if (io.t_next) *io.t_next = *io.t + 1;
  }
  const int n_entries = n_real * k.k_pad;   // < 2^30 (the wrapper checks)
  for (int e0 = g; e0 < n_entries; e0 += kUnroll * threads) {
    int tg[kUnroll], bin[kUnroll], ch[kUnroll];
    float w[kUnroll], xq[kUnroll];
    bool pm[kUnroll];
    size_t at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * threads;
      tg[u] = n_tgt;
      pm[u] = false;
      if (e < n_entries) {
        const int s = e / k.k_pad;
        const int sid = io.ids[s];
        at[u] = static_cast<size_t>(sid) * k.k_pad + (e - s * k.k_pad);
        ch[u] = sid >= k.n_exc ? 1 : 0;
        tg[u] = k.targets[at[u]];
        bin[u] = k.dbins[at[u]];
        w[u] = k.weights[at[u]];
        if constexpr (kPlastic) pm[u] = k.pmask[at[u]] != 0;
      }
    }
    if constexpr (kPlastic) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (pm[u] && tg[u] < n_tgt) xq[u] = io.x_post[tg[u]];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (tg[u] >= n_tgt) continue;   // padding (weight 0), or no entry
      const int slot = (t_prev + bin[u]) % k.d_bins;
      atomicAdd(io.ring + (static_cast<size_t>(slot) * 2 + ch[u]) * n_cols +
                    tg[u],
                w[u]);
      if constexpr (kPlastic) {
        if (pm[u]) k.weights[at[u]] = stdp_depressed(w[u], k.dep_coef, xq[u]);
      }
    }
  }
  stamp<kStamps, kStamped>(io.stamps, 5);
  if constexpr (kForm == Form::kDeliver) return;
  grid.sync();
  stamp<kStamps, kStamped>(io.stamps, 6);

  // 3. LIF update against the just-delivered slot, which it then consumes
  // (K3 and K4: n_tgt == n, so the ring's columns are the neurons and the
  // dump column)
  const int slot = (t_prev + 1) % k.d_bins;
  float* row_ex = io.ring + static_cast<size_t>(slot) * 2 * n_cols;
  float* row_in = row_ex + n_cols;
  for (int i = g; i < n_cols; i += threads) {
    if (i < n) {
      const Neuron x = load_neuron<kPlastic>(k, io, i);
      const float in_ex =
          io.ext_cnt ? __fadd_rn(row_ex[i], x.ext_ex) : row_ex[i];
      lif_neuron(k.p, x.V, x.I_ex, x.I_in, x.refrac, in_ex, row_in[i],
                 x.i_dc, io.Vo + i, io.Iexo + i, io.Iino + i, io.refo + i,
                 io.spk + i);
      if (kPlastic && io.trace) {
        io.x_pre_o[i] = stdp_trace(x.x_pre, k.decay_p, x.spiked_prev);
        io.x_post_o[i] = stdp_trace(x.x_post, k.decay_m, x.spiked_prev);
      }
    }
    row_ex[i] = 0.0f;
    row_in[i] = 0.0f;
  }
  stamp<kStamps, kStamped>(io.stamps, 7);
}

template <Form kForm, bool kStamped>
int launch(const StepConst* k, const StepIO& io, void* stream) {
  StepArgs a{*k, io};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k->grid);
  cfg.blockDim = dim3(kBlock);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, lif_deliver_kernel<kForm, kStamped>, a);
  // cudaGetLastError() also clears a refused launch's error, so the next
  // launch does not report it as its own.
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// The grid of K2, K3 and K4 on this card: one block per SM (fewer when the
// ring has fewer than kMinColumns columns per SM).  Returns -1 when the card
// has no cooperative launch, -2 when a block does not fit on an SM.
EXPORT int lif_deliver_grid(int n_cols, int* grid_out) {
  int dev = 0, coop = 0, sms = 0, fit = 0, fit_pl = 0, fit_dl = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, lif_deliver_kernel<Form::kStep, true>, kBlock, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit_pl, lif_deliver_kernel<Form::kPlasticStep, true>, kBlock, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit_dl, lif_deliver_kernel<Form::kDeliver, true>, kBlock, 0);
  if (std::min({fit, fit_pl, fit_dl}) < 1) return -2;
  *grid_out = std::min(sms, (n_cols + kMinColumns - 1) / kMinColumns);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(StepConst), which the wrapper's ctypes mirror must equal; the
// workspace's words for `grid` blocks; the stamps a block writes.
EXPORT int lif_deliver_const_bytes() { return sizeof(StepConst); }
EXPORT int lif_deliver_workspace_words(int grid) { return 1 + grid; }
EXPORT int lif_deliver_stamps() { return kStamps; }

#define STEP_IO_PARAMS                                                      \
  const unsigned char *spiked_prev, float *ring, const float *V,            \
      const float *I_ex, const float *I_in, const int *refrac,              \
      const float *ext_cnt, const float *i_dc, float *Vo, float *Iexo,      \
      float *Iino, int *refo, unsigned char *spk, int *ids, int *overflow,  \
      const int *t, const int *overflow_in, int *t_next

#define STEP_IO                                                             \
  StepIO io{spiked_prev, ring, V,    I_ex,    I_in,     refrac,  ext_cnt,   \
            i_dc,        Vo,   Iexo, Iino,    refo,     spk,     ids,       \
            overflow,    nullptr, nullptr, nullptr, nullptr, nullptr,       \
            t,           -1,   0,    overflow_in, t_next}

#define PLASTIC_PARAMS                                                      \
  const float *x_pre, const float *x_post, float *x_pre_o, float *x_post_o, \
      int trace

#define PLASTIC_IO                                                          \
  io.x_pre = x_pre;                                                         \
  io.x_post = x_post;                                                       \
  io.x_pre_o = x_pre_o;                                                     \
  io.x_post_o = x_post_o;                                                   \
  io.trace = trace

// K3.  `k` is the session's constant pack (tables, sizes, propagators,
// grid, workspace, w_ext), built once by the wrapper; ext_cnt may be null
// (no spike drive); overflow_in is the running overflow, and the launch
// writes the new one into `overflow` and t + 1 into t_next.
EXPORT int lif_deliver_launch(const StepConst* k, STEP_IO_PARAMS,
                              void* stream) {
  STEP_IO;
  return launch<Form::kStep, false>(k, io, stream);
}

// K4: K3's arguments (k->weights: the live table, updated in place), then
// the traces before the step, their new buffers and whether to update them.
EXPORT int lif_deliver_plastic_launch(const StepConst* k, STEP_IO_PARAMS,
                                      PLASTIC_PARAMS, void* stream) {
  STEP_IO;
  PLASTIC_IO;
  return launch<Form::kPlasticStep, false>(k, io, stream);
}

// The stamped instantiations, for chip_smoke.py's phase table: as above,
// and each block writes its kStamps %globaltimer stamps into
// stamps[blockIdx.x * kStamps ...].
EXPORT int lif_deliver_stamped_launch(const StepConst* k, STEP_IO_PARAMS,
                                      unsigned long long* stamps,
                                      void* stream) {
  STEP_IO;
  io.stamps = stamps;
  return launch<Form::kStep, true>(k, io, stream);
}

EXPORT int lif_deliver_plastic_stamped_launch(const StepConst* k,
                                              STEP_IO_PARAMS, PLASTIC_PARAMS,
                                              unsigned long long* stamps,
                                              void* stream) {
  STEP_IO;
  PLASTIC_IO;
  io.stamps = stamps;
  return launch<Form::kPlasticStep, true>(k, io, stream);
}

// K2: phases 1 and 2 alone, on the workspace that K3 and K4 use.  `k` is a
// pack of the session's tables, sizes and workspace (its propagators and
// pmask unused); delivers `spiked` ([n]) at phase *t into `ring` ([D, 2,
// n_tgt + 1]), writes the ids and the overflow.
#define DELIVER_IO                                                          \
  StepIO io{spiked,  ring,    nullptr, nullptr, nullptr, nullptr, nullptr,  \
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, ids,      \
            overflow, nullptr, nullptr, nullptr, nullptr, nullptr, t, 0, 0,  \
            nullptr,  nullptr}

EXPORT int ell_deliver_launch(const StepConst* k,
                              const unsigned char* spiked, float* ring,
                              int* ids, int* overflow, const int* t,
                              void* stream) {
  DELIVER_IO;
  return launch<Form::kDeliver, false>(k, io, stream);
}

EXPORT int ell_deliver_stamped_launch(const StepConst* k,
                                      const unsigned char* spiked,
                                      float* ring, int* ids, int* overflow,
                                      const int* t,
                                      unsigned long long* stamps,
                                      void* stream) {
  DELIVER_IO;
  io.stamps = stamps;
  return launch<Form::kDeliver, true>(k, io, stream);
}
