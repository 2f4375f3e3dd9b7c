// Shared pieces of the port's hand-written Hopper kernels.
//
// Each .cu file is built by nvcc into its own shared library with a plain C
// interface (repro_torch/kernels/_build.py) and loaded with ctypes.  Every
// launch function returns cudaGetLastError() right after its launches; the
// Python wrapper raises on a non-zero code, with kernel_error_string().
#pragma once

#include <cuda_runtime.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

EXPORT const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Stamp k of this block, of kStamps a block, for the phase tables of a
// stamped launch (lif_deliver.cu, stdp_update.cu): %globaltimer (ns) into
// s[blockIdx.x * kStamps + k], once all the block's threads are past the
// point.  The stamps' own __syncthreads sit inside the phases they bound.
template <int kStamps, bool kOn>
__device__ __forceinline__ void stamp(unsigned long long* s, int k) {
  if constexpr (kOn) {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      s[blockIdx.x * kStamps + k] = t;
    }
  }
}

// Propagators of one exact-integration iaf_psc_exp step, rounded to float32
// on the host exactly as PyTorch rounds a Python float scalar.
struct LifProp {
  float P11_ex, P11_in, P22, P21_ex, P21_in, P20, V_th, V_reset, E_L;
  int ref_steps;
};

// One neuron's step, in the reference's operation order
// (repro/kernels/lif_update.py:36-53, repro/core/neuron.py:92-109).  Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn never
// contract into an FMA), so the result equals the plain PyTorch version bit
// for bit.
__device__ __forceinline__ void lif_neuron(
    const LifProp& p, float V, float I_ex, float I_in, int refrac,
    float in_ex, float in_in, float i_dc,
    float* Vo, float* Iexo, float* Iino, int* refo, unsigned char* spk) {
  float v = __fadd_rn(p.E_L, __fmul_rn(__fsub_rn(V, p.E_L), p.P22));
  v = __fadd_rn(v, __fmul_rn(I_ex, p.P21_ex));
  v = __fadd_rn(v, __fmul_rn(I_in, p.P21_in));
  v = __fadd_rn(v, __fmul_rn(i_dc, p.P20));
  *Iexo = __fadd_rn(__fmul_rn(I_ex, p.P11_ex), in_ex);
  *Iino = __fadd_rn(__fmul_rn(I_in, p.P11_in), in_in);
  const bool refractory = refrac > 0;
  if (refractory) v = p.V_reset;
  const bool fired = (v >= p.V_th) && !refractory;
  *Vo = fired ? p.V_reset : v;
  *refo = fired ? p.ref_steps : max(refrac - 1, 0);
  *spk = fired ? 1 : 0;
}

// Pair STDP, one synapse or trace at a time (K4 in lif_deliver.cu, the
// update in stdp_update.cu), each in the plain version's operation order
// (repro_torch/kernels/stdp.py) with every product and sum rounded on its
// own, so both kernels equal it bit for bit.

// Depression of a plastic entry: w + (-(dep * x_post[target])).
__device__ __forceinline__ float stdp_depressed(float w, float dep,
                                                float x_post) {
  return __fadd_rn(w, -__fmul_rn(dep, x_post));
}

// Potentiation of a plastic entry: w + pot * x_pre[source].
__device__ __forceinline__ float stdp_potentiated(float w, float pot,
                                                  float x_pre) {
  return __fadd_rn(w, __fmul_rn(pot, x_pre));
}

// The clip to [0, w_max]; a NaN passes, as through torch.clamp.
__device__ __forceinline__ float stdp_clipped(float w, float w_max) {
  return w < 0.0f ? 0.0f : (w > w_max ? w_max : w);
}

// A trace's decay and bump: x * decay + spike.
__device__ __forceinline__ float stdp_trace(float x, float decay,
                                            unsigned char spiked) {
  return __fadd_rn(__fmul_rn(x, decay), spiked ? 1.0f : 0.0f);
}
