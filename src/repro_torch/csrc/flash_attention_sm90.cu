// K6 on Hopper's tensor cores: bf16 flash attention with wgmma, TMA and an
// mbarrier ring (sm_90a).  The float32 path stays on the CUDA cores in
// flash_attention.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel, pallas_call at :90), with the
// semantics of flash_attention.cu: for each batch b, query head h (KV head
// h / (Hq / Hkv)) and query row r, key c is live when c < S and, if
// causal, c <= q_offset + r; out[r] = sum_c softmax(s)[c] * v[c] over the
// live keys, s[c] = (q[r] . k[c]) * scale, and 0 where no key is live.
// Inputs and output are bfloat16, every sum is float32.
//
// Bound: 4 * B * Hq * D * (live query-key pairs) operations against
// 2 * (|q| + |k| + |v| + |out|) bytes; at the Qwen3-32B shape (B = 1,
// Hq = 64, Hkv = 8, D = 128, T = S = 4096, causal) 275 GFLOP against
// 151 MB, so operations bound it: 0.28 ms at the 989 TFLOP/s bf16
// tensor-core rate.  Only wgmma reaches that rate, so both products run
// there:
//
// * One block of 384 threads owns 128 query rows of one (b, h).
//   Warpgroup 0 is the producer: one thread issues TMA loads of the Q tile
//   (once) and of each 128-key K and V tile into a ring of kStages
//   stages, each with a "full" mbarrier (TMA's byte count) and an "empty"
//   one (one arrival from each of the 8 consumer warps).  Warpgroups 1 and
//   2 are the consumers, 64 query rows each; setmaxnreg moves registers
//   from the producer (40) to them (232).
// * S = Q . K^T is wgmma m64n128k16 with both operands in shared memory,
//   K-major, in the 128-byte swizzle that TMA writes (64-byte at D = 32;
//   a D = 128 row is two 64-wide boxes).  The accumulator stays in
//   registers: a thread holds two rows (g and g + 8 of its warp's 16) and
//   32 keys of each.
// * The online softmax runs on that fragment: the row max over the 4
//   threads of a quad by __shfl_xor_sync, p = exp2(s * scale*log2(e) -
//   m * scale*log2(e)) as one explicit __fmaf_rn (the build has
//   --fmad=false), l summed from the float32 p and reduced over the quad
//   only at the end, the O accumulator rescaled in registers.
// * O += P . V is wgmma m64nDk16 with P as A from registers: the float32
//   fragment of 16 keys of S is, pair by pair, the bf16 A fragment of one
//   k16 slice, so P never touches shared memory.  P is rounded to bf16
//   there, as repro/models/layers.py:187 and scaled_dot_product_attention
//   round it; kernels/flash_attention.py:bf16_bar is the bar that follows.
//   V is the B operand MN-major (D contiguous) with the transpose bit.
// * Causally dead K/V tiles are never loaded; the mask is applied only on
//   tiles that cross the diagonal or S; a consumer whose 64 rows see none
//   of a tile's keys skips it; blocks run in reverse query order so that
//   the longest rows start first.  TMA fills rows past T or S with zeros,
//   and the mask still excludes keys >= S.
// * Tensor maps are 4-D ([D, L, H, B], any batch, head and row strides in
//   multiples of 16 bytes), encoded on the host per call through
//   cudaGetDriverEntryPoint (no -lcuda) and passed as __grid_constant__.
//
// Not here yet (ROADMAP): ping-pong scheduling of the two consumers,
// overlap of the softmax with the next product inside a warpgroup,
// persistent blocks, one block over a GQA group's query heads.
//
// Shared memory: Q 32 KB and two stages of K and V (64 KB each) at
// D = 128, 160 KB and the barriers: one block an SM.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBq = 128;          // query rows per block
constexpr int kBk = 128;          // keys per K/V tile
constexpr int kStages = 2;        // depth of the K/V ring
constexpr int kThreads = 384;     // the producer's warpgroup and two more
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536,
              "setmaxnreg asks for more registers than an SM has");

// The shared-memory layout of one head dim.  A tile row of D bf16 is cut
// into D / kChunk boxes of kChunk elements, one swizzled row of kRowBytes
// each; box c of a 128-row tile is a [128][kChunk] block at c * kChunkBytes.
template <int D>
struct Cfg {
  static constexpr int kChunk = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kChunk;             // 64 or 128
  static constexpr int kChunks = D / kChunk;
  static constexpr int kChunkBytes = kBk * kRowBytes;
  static constexpr int kTileBytes = kBk * D * 2;           // Q, K or V tile
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128/B64
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  // the base is rounded up to 1024 bytes, where the swizzle repeats
  static constexpr int kSmem = kTileBytes * (1 + 2 * kStages) + kBarBytes
                               + 1024;
  static_assert(kBq == kBk, "Q and K/V tiles share one box shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------
// One box of a 4-D tensor map into shared memory at `dst`, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// -- wgmma -------------------------------------------------------------------
// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32]; A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]; A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_sm90_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    long long sob, long long soh, long long sol, int hq, int group,
    int t_len, int s_len, float scale_log2, int causal, int q_offset) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // stage s holds K at sQ + (1 + 2s) tiles and V one tile further
  const uint32_t bars = sQ + C::kTileBytes * (1 + 2 * kStages);
  const uint32_t q_full = bars;
  const uint32_t full0 = bars + 8, empty0 = bars + 8 * (1 + kStages);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;  // longest rows first
  const int b = blockIdx.y / hq, h = blockIdx.y % hq, hk = h / group;
  const int k_end = causal ? min(s_len, q_offset + q0 + kBq) : s_len;
  const int n_tiles = (k_end + kBk - 1) / kBk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kTileBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(sQ + c * C::kChunkBytes, &q_map, q_full, c * C::kChunk, q0,
                 h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t use = j / kStages;
        mbar_wait(empty0 + 8 * s, (use & 1) ^ 1);   // use 0 passes at once
        const uint32_t full = full0 + 8 * s;
        const uint32_t sK = sQ + C::kTileBytes * (1 + 2 * s);
        const uint32_t sV = sK + C::kTileBytes;
        mbar_expect_tx(full, 2 * C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(sK + c * C::kChunkBytes, &k_map, full, c * C::kChunk,
                   j * kBk, hk, b);
          tma_load(sV + c * C::kChunkBytes, &v_map, full, c * C::kChunk,
                   j * kBk, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4 - 1, wq = warp % 4;
    const int g = lane / 4, tq = lane % 4;
    const int row_lo = q0 + 64 * wg;              // the warpgroup's first row
    const int r0 = row_lo + 16 * wq + g;          // this thread's rows r0, r0+8
    // causal: the last key that any row of the warpgroup sees, and the last
    // key that all of them see
    const int key_hi = q_offset + row_lo + 63, key_lo = q_offset + row_lo;

    float acc[D / 2], sc[64];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    const uint32_t sQw = sQ + 64 * wg * C::kRowBytes;
    constexpr uint32_t kSbo = 8 * C::kRowBytes;     // 8 rows of one box
    constexpr int kSteps = C::kChunk / 16;           // k16 steps in one box
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t use = j / kStages;
      const int k0 = j * kBk;
      mbar_wait(full0 + 8 * s, use & 1);
      if (!causal || k0 <= key_hi) {
        const uint32_t sK = sQ + C::kTileBytes * (1 + 2 * s);
        const uint32_t sV = sK + C::kTileBytes;

        // S = Q . K^T, D / 16 steps of k16
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / kSteps) * C::kChunkBytes
                               + (kk % kSteps) * 32;
          wgmma_ss_n128(sc, gmma_desc(sQw + off, 16, kSbo, C::kLayout),
                        gmma_desc(sK + off, 16, kSbo, C::kLayout), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // the mask, on tiles that cross the diagonal or S only.  sc[4n + e]
        // is row r0, key k0 + 8n + 2tq + e; sc[4n + 2 + e] row r0 + 8.
        if (k0 + kBk > s_len || (causal && k0 + kBk - 1 > key_lo)) {
          const int lim0 = causal ? min(s_len - 1, q_offset + r0) : s_len - 1;
          const int lim1 = causal ? min(s_len - 1, q_offset + r0 + 8)
                                  : s_len - 1;
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * n + 2 * tq + e;
              if (key > lim0) sc[4 * n + e] = -INFINITY;
              if (key > lim1) sc[4 * n + 2 + e] = -INFINITY;
            }
        }

        // online softmax on the fragment
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
        }
        float neg_ms[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // a row with no live key yet: exp2 of -inf gives 0
          neg_ms[r] = mx[r] == -INFINITY ? 0.f : -mx[r] * scale_log2;
          alpha[r] = exp2_approx(__fmaf_rn(m[r], scale_log2, neg_ms[r]));
          m[r] = mx[r];
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2_approx(__fmaf_rn(sc[i], scale_log2, neg_ms[r]));
          sum[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], alpha[r], sum[r]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // P in bf16: keys 16kk .. 16kk + 15 of S are the A fragment of
        // step kk
        uint32_t p[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

        // O += P . V, 8 steps of k16 keys
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) fence_regs(p[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_pv<D>(acc, p[kk],
                      gmma_desc(sV + kk * 16 * C::kRowBytes, C::kChunkBytes,
                                kSbo, C::kLayout));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) fence_regs(p[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);   // the stage is free
    }

    // epilogue: l over the quad, out = acc / l (0 where no key was live)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = l[r] == 0.f ? 1.f : l[r];
    }
    __nv_bfloat16* ob = o + b * sob + h * soh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= t_len) continue;
      __nv_bfloat16* orow = ob + row * sol + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] / l[r],
                                  acc[4 * n + 2 * r + 1] / l[r]);
    }
  }
}

// -- host --------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of one [B, H, L, D] operand (element strides sb, sh, sl; the last
// dim contiguous) in boxes of [128 rows][chunk] with the given swizzle.  A
// dim of size 1 is never stepped over; it gets the stride of a packed
// layout, since TMA wants every stride a multiple of 16 bytes.
int encode(CUtensorMap* map, const void* ptr, int d, int l, int h, int b,
           long long sb, long long sh, long long sl, int chunk,
           CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long packed[3] = {2LL * d * l * h, 2LL * d * l, 2LL * d};
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(l),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(l > 1 ? 2 * sl : packed[2]),
      static_cast<cuuint64_t>(h > 1 ? 2 * sh : packed[1]),
      static_cast<cuuint64_t>(b > 1 ? 2 * sb : packed[0])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk),
                             static_cast<cuuint32_t>(kBk), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int b, int hq, int hkv, int t, int s,
           float scale, int causal, int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  const CUtensorMapSwizzle swz = C::kRowBytes == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qm, km, vm;
  int err = encode(&qm, q, D, t, hq, b, st[0], st[1], st[2], C::kChunk, swz);
  if (!err) err = encode(&km, k, D, s, hkv, b, st[3], st[4], st[5],
                         C::kChunk, swz);
  if (!err) err = encode(&vm, v, D, s, hkv, b, st[6], st[7], st[8],
                         C::kChunk, swz);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t + kBq - 1) / kBq, b * hq);
  flash_sm90_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], hq,
      hq / hkv, t, s, scale * 1.4426950408889634f, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, hq, t, d], k and v [b, hkv, s, d], o [b, hq, t, d], all bfloat16,
// each given by its data pointer and its batch, head and row strides in
// elements (the last dim contiguous; data 16-byte aligned and strides
// multiples of 8, for TMA, which the wrapper checks); d in {32, 64, 128};
// hq % hkv == 0; t >= 1, s >= 1; scale > 0; q_offset >= 0.
EXPORT int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* o, long long sqb,
    long long sqh, long long sql, long long skb, long long skh,
    long long skl, long long svb, long long svh, long long svl,
    long long sob, long long soh, long long sol, int b, int hq, int hkv,
    int t, int s, int d, float scale, int causal, int q_offset,
    void* stream) {
  const long long st[12] = {sqb, sqh, sql, skb, skh, skl,
                            svb, svh, svl, sob, soh, sol};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, st, b, hq, hkv, t, s, scale, causal,
                        q_offset, cs);
    case 64:
      return launch<64>(q, k, v, o, st, b, hq, hkv, t, s, scale, causal,
                        q_offset, cs);
    case 128:
      return launch<128>(q, k, v, o, st, b, hq, hkv, t, s, scale, causal,
                         q_offset, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of one block at head dim d (0 for another d).
EXPORT int flash_attention_sm90_smem_bytes(int d) {
  return d == 32 ? Cfg<32>::kSmem
         : d == 64 ? Cfg<64>::kSmem
         : d == 128 ? Cfg<128>::kSmem : 0;
}
