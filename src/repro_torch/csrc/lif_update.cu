// K1: one exact-integration iaf_psc_exp step over N neurons.
//
// Replaces the TPU kernel repro/kernels/lif_update.py:lif_update_pallas
// (body _kernel, pallas_call at :76).  One thread per neuron, elementwise:
// 7 [N] inputs read once, 5 [N] outputs written once, about 45 B per neuron,
// so the card's memory rate bounds it (3.5 MB per step at N = 77,169, about
// 1 us at 3.35 TB/s).  The TPU kernel's (8, 128) tiles have no counterpart
// here: neighbouring threads read neighbouring words, which is all a
// bandwidth-bound elementwise pass needs.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) lif_update_kernel(
    const float* __restrict__ V, const float* __restrict__ I_ex,
    const float* __restrict__ I_in, const int* __restrict__ refrac,
    const float* __restrict__ in_ex, const float* __restrict__ in_in,
    const float* __restrict__ i_dc, float* __restrict__ Vo,
    float* __restrict__ Iexo, float* __restrict__ Iino,
    int* __restrict__ refo, unsigned char* __restrict__ spk, int n,
    LifProp p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lif_neuron(p, V[i], I_ex[i], I_in[i], refrac[i], in_ex[i], in_in[i],
             i_dc[i], Vo + i, Iexo + i, Iino + i, refo + i, spk + i);
}

}  // namespace

EXPORT int lif_update_launch(const float* V, const float* I_ex,
                             const float* I_in, const int* refrac,
                             const float* in_ex, const float* in_in,
                             const float* i_dc, float* Vo, float* Iexo,
                             float* Iino, int* refo, unsigned char* spk,
                             int n, float P11_ex, float P11_in, float P22,
                             float P21_ex, float P21_in, float P20,
                             float V_th, float V_reset, float E_L,
                             int ref_steps, void* stream) {
  const LifProp p{P11_ex, P11_in, P22, P21_ex, P21_in, P20,
                  V_th,   V_reset, E_L, ref_steps};
  const int block = 256;
  const int grid = (n + block - 1) / block;
  if (grid > 0)
    lif_update_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        V, I_ex, I_in, refrac, in_ex, in_in, i_dc, Vo, Iexo, Iino, refo, spk,
        n, p);
  return static_cast<int>(cudaGetLastError());
}
