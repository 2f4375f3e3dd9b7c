"""LIF neuron with exponential post-synaptic currents (NEST `iaf_psc_exp`).

Exact integration (Rotter & Diesmann 1999), as ``repro.core.neuron``:

    I_x' = P11_x * I_x + in_x
    V'   = E_L + (V - E_L) P22 + I_ex P21_ex + I_in P21_in + I_dc P20

then the refractory clamp, threshold and reset.  ``lif_step`` is the plain
PyTorch version; the hand-written CUDA kernel ``kernels/lif_update`` keeps
exactly this operation order (and no fused multiply-adds), so the two agree
bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.params import NeuronParams


@dataclasses.dataclass(frozen=True)
class Propagators:
    """Step propagators for a fixed dt, as Python floats."""
    P11_ex: float
    P11_in: float
    P22: float
    P21_ex: float
    P21_in: float
    P20: float
    ref_steps: int
    V_th: float
    V_reset: float
    E_L: float

    @staticmethod
    def make(p: NeuronParams, dt: float) -> "Propagators":
        p22 = float(np.exp(-dt / p.tau_m))

        def p21(tau_x: float) -> float:
            return float(
                (np.exp(-dt / tau_x) - np.exp(-dt / p.tau_m))
                / (p.C_m * (1.0 / p.tau_m - 1.0 / tau_x)))

        return Propagators(
            P11_ex=float(np.exp(-dt / p.tau_syn_ex)),
            P11_in=float(np.exp(-dt / p.tau_syn_in)),
            P22=p22,
            P21_ex=p21(p.tau_syn_ex),
            P21_in=p21(p.tau_syn_in),
            P20=float(p.tau_m / p.C_m * (1.0 - p22)),
            ref_steps=int(round(p.t_ref / dt)),
            V_th=p.V_th,
            V_reset=p.V_reset,
            E_L=p.E_L,
        )


class NeuronState(NamedTuple):
    V: torch.Tensor        # [N] membrane potential, mV
    I_ex: torch.Tensor     # [N] excitatory synaptic current, pA
    I_in: torch.Tensor     # [N] inhibitory synaptic current, pA
    refrac: torch.Tensor   # [N] int32, remaining refractory steps


def lif_step(state: NeuronState, prop: Propagators, in_ex: torch.Tensor,
             in_in: torch.Tensor, i_dc: torch.Tensor):
    """One exact-integration step; returns ``(new_state, spiked[bool N])``.

    V is updated with the pre-jump currents; the step's arriving input
    joins the currents after their decay (the reference's order).  Python
    float propagators are rounded to the state's float32 like JAX's weakly
    typed scalars, so each op rounds exactly as the reference's does.
    """
    V_new = (prop.E_L
             + (state.V - prop.E_L) * prop.P22
             + state.I_ex * prop.P21_ex
             + state.I_in * prop.P21_in
             + i_dc * prop.P20)

    I_ex_new = state.I_ex * prop.P11_ex + in_ex
    I_in_new = state.I_in * prop.P11_in + in_in

    refractory = state.refrac > 0
    V_new = torch.where(refractory, prop.V_reset, V_new)

    spiked = (V_new >= prop.V_th) & ~refractory
    V_new = torch.where(spiked, prop.V_reset, V_new)
    refrac_new = torch.where(
        spiked, prop.ref_steps,
        torch.clamp(state.refrac - 1, min=0)).to(state.refrac.dtype)

    return NeuronState(V_new, I_ex_new, I_in_new, refrac_new), spiked
