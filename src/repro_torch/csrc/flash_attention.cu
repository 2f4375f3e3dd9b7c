// K6, float32 path: causal or full GQA attention with an online softmax
// (flash attention) on the CUDA cores.  bfloat16 inputs take the
// tensor-core kernel of flash_attention_sm90.cu; the wrapper
// (kernels/flash_attention.py) picks by dtype.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel, pallas_call at :90).  For each
// batch b, query head h (KV head h / (Hq / Hkv)) and query row r:
//
//   s[c]   = (q[r] . k[c]) * scale           for the live keys c
//   out[r] = sum_c softmax(s)[c] * v[c]      (0 where no key is live)
//
// A key c is live when c < S and, if causal, c <= q_offset + r: with
// q_offset 0 the causal mask is top-left aligned (query 0 sees key 0), as
// in the TPU kernel and in repro/models/layers.py:_mha_block with q_offset
// 0; a prefill into a KV cache passes the cache's index as q_offset and
// the cache's filled prefix as K and V.  Inputs, output and every sum are
// float32.
//
// The TPU kernel runs its kv-block grid axis in order on one core and
// carries the running max m, denominator l and accumulator in VMEM scratch
// from one grid step to the next.  Here one block of 256 threads owns one
// (b * Hq + h, 64-row query tile) and loops over the 64-key K/V tiles
// itself, so m, l and the accumulator stay in registers for the whole
// row: each thread holds 4 rows x 4 keys of the score tile and 4 rows x
// D/16 columns of the output.  Q stays in shared memory transposed (Qt),
// K is staged transposed (Kt) and then V row-major in the same buffer, and
// the tile's probabilities go through shared memory (Pt) to the P.V
// product.  Both products are float32 FMAs on the CUDA cores (explicit
// __fmaf_rn: the build's --fmad=false forbids only implicit contraction),
// so float32 inputs keep float32 products; the tensor cores would take
// them only as TF32.  Ragged T and S are masked here, not padded by the
// wrapper; keys past S are staged as zeros.  Causally dead K/V tiles are
// never loaded, and the tiles run in reverse query order so the longest
// rows start first.
//
// Bound: 4 * B * Hq * D * (live query-key pairs) operations (the two
// products) against 4 * (|q| + |k| + |v| + |out|) bytes; at the Qwen3-32B
// shape (B = 1, Hq = 64, Hkv = 8, D = 128, T = S = 4096, causal) that is
// 275 GFLOP against 302 MB, so operations bound it: 4.1 ms at the
// 67 TFLOP/s float32 rate.
//
// Shared memory: Qt [D][68], the K/V buffer [D][68], Pt [64][68] floats,
// 85 KB at D = 128, so two blocks fit on an SM.  The transposed rows are
// 68 floats wide so that float4 reads stay aligned and the per-key stores
// of K and P fall on distinct banks.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16: tx over keys/columns, ty over rows
constexpr int kLd = 68;        // row stride of the transposed tiles
static_assert(kBq == kBk, "Q and K/V tiles are staged by one routine");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Element strides of one [B, H, L, D] operand; the last dim is contiguous.
struct Strides {
  long long b, h, l;
};

// A [kBq or kBk rows][D] tile starting at row `row0` of `src`, rows past
// `n_rows` as zeros, into dst transposed: dst[d * kLd + row].  Each thread
// moves 4 consecutive d of one row; neighbouring threads take neighbouring
// rows, so the shared stores fall on distinct banks.
template <int D>
__device__ __forceinline__ void stage_transposed(const float* src, long long ld,
                                                 int row0, int n_rows,
                                                 float* dst) {
  constexpr int kChunks = kBk * D / 4;
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int row = i % kBk, d = (i / kBk) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < n_rows) x = load4(src + (row0 + row) * ld + d);
    dst[(d + 0) * kLd + row] = x.x;
    dst[(d + 1) * kLd + row] = x.y;
    dst[(d + 2) * kLd + row] = x.z;
    dst[(d + 3) * kLd + row] = x.w;
  }
}

// The same tile row-major: dst[row * D + d].
template <int D>
__device__ __forceinline__ void stage_rows(const float* src, long long ld,
                                           int row0, int n_rows, float* dst) {
  constexpr int kChunks = kBk * D / 4;
  for (int i = threadIdx.x; i < kChunks; i += kThreads) {
    const int row = i / (D / 4), d = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < n_rows) x = load4(src + (row0 + row) * ld + d);
    *reinterpret_cast<float4*>(dst + row * D + d) = x;
  }
}

template <int D>
constexpr int smem_floats() {
  return 2 * D * kLd + kBk * kLd;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
    Strides sv, Strides so, int hq, int group, int t_len, int s_len,
    float scale, int causal, int q_offset) {
  static_assert(D % 64 == 0 || D == 32, "D must be 32 or a multiple of 64");
  constexpr int kVec = D >= 64 ? 4 : 2;          // P.V columns per load
  constexpr int kNv = D / (16 * kVec);           // loads per key
  constexpr int kCols = kVec * kNv;              // = D / 16
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kLd]
  float* KV = Qt + D * kLd;                      // Kt [D][kLd] or V [kBk][D]
  float* Pt = KV + D * kLd;                      // [kBk][kLd]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int b = blockIdx.y / hq, h = blockIdx.y % hq, hk = h / group;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  stage_transposed<D>(qb, sq.l, q0, t_len, Qt);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(s_len, q_offset + q0 + kBq) : s_len;
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the last tile's P.V is done with KV and Pt
    stage_transposed<D>(kb, sk.l, k0, s_len, KV);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = load4(Qt + d * kLd + ty * 4);
      const float* kr = KV + d * kLd + tx;
      const float kk[4] = {kr[0], kr[16], kr[32], kr[48]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = __fmaf_rn(qa.x, kk[j], s[0][j]);
        s[1][j] = __fmaf_rn(qa.y, kk[j], s[1][j]);
        s[2][j] = __fmaf_rn(qa.z, kk[j], s[2][j]);
        s[3][j] = __fmaf_rn(qa.w, kk[j], s[3][j]);
      }
    }

    // online softmax; a row's 64 keys lie in the 16 lanes of its tx group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_offset + q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < s_len && (!causal || col <= row);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      l[i] = __fmaf_rn(l[i], alpha, sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx + 16 * j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // Kt is read, Pt written
    stage_rows<D>(vb, sv.l, k0, s_len, KV);
    __syncthreads();

    // acc[i][c] += sum_key P[row][key] * V[key][col]
    const int n_keys = min(kBk, s_len - k0);
    for (int key = 0; key < n_keys; ++key) {
      const float4 pa = load4(Pt + key * kLd + ty * 4);
      const float* vr = KV + key * D + tx * kVec;
#pragma unroll
      for (int n = 0; n < kNv; ++n) {
        float vv[kVec];
        if constexpr (kVec == 4) {
          const float4 x = load4(vr + 16 * kVec * n);
          vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
        } else {
          const float2 x =
              *reinterpret_cast<const float2*>(vr + 16 * kVec * n);
          vv[0] = x.x; vv[1] = x.y;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int c = n * kVec + e;
          acc[0][c] = __fmaf_rn(pa.x, vv[e], acc[0][c]);
          acc[1][c] = __fmaf_rn(pa.y, vv[e], acc[1][c]);
          acc[2][c] = __fmaf_rn(pa.z, vv[e], acc[2][c]);
          acc[3][c] = __fmaf_rn(pa.w, vv[e], acc[3][c]);
        }
      }
    }
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= t_len) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];  // no live key -> 0
    float* orow = ob + row * so.l;
#pragma unroll
    for (int n = 0; n < kNv; ++n)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        orow[tx * kVec + 16 * kVec * n + e] = acc[i][n * kVec + e] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           Strides sq, Strides sk, Strides sv, Strides so, int b, int hq,
           int hkv, int t, int s, float scale, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  // above 48 KB a block's shared memory must be asked for (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBq - 1) / kBq, b * hq);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so, hq,
      hq / hkv, t, s, scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             Strides sq, Strides sk, Strides sv, Strides so, int b, int hq,
             int hkv, int t, int s, float scale, int causal, int q_offset,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, sq, sk, sv, so, b, hq, hkv, t, s,
                           scale, causal, q_offset, stream);
    case 64:
      return launch<64>(q, k, v, o, sq, sk, sv, so, b, hq, hkv, t, s,
                           scale, causal, q_offset, stream);
    case 128:
      return launch<128>(q, k, v, o, sq, sk, sv, so, b, hq, hkv, t, s,
                            scale, causal, q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [b, hq, t, d], k and v [b, hkv, s, d], o [b, hq, t, d], each given by
// its data pointer and its batch, head and row strides in elements (the
// last dim contiguous; strides multiples of 4 and pointers 16-byte
// aligned, which the wrapper checks); all float32; d in {32, 64, 128};
// hq % hkv == 0; t >= 1; q_offset >= 0.
EXPORT int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long sqb,
    long long sqh, long long sql, long long skb, long long skh,
    long long skl, long long svb, long long svh, long long svl,
    long long sob, long long soh, long long sol, int b, int hq, int hkv,
    int t, int s, int d, float scale, int causal, int q_offset,
    void* stream) {
  const Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl},
      so{sob, soh, sol};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_d(d, q, k, v, o, sq, sk, sv, so, b, hq, hkv, t, s, scale,
                  causal, q_offset, st);
}
