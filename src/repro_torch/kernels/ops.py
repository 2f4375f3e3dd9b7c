"""Wrappers around the kernels with the reference's signatures
(``repro/kernels/ops.py:26``, ``:37``, ``:44``, ``:64``, ``:94`` and
``:134``).

Each takes the engine's types (``NeuronState``, ``EventTables``) and runs
its kernel on CUDA tensors or its plain version on CPU tensors.  The step
counter ``t`` is the engine's 0-d int32 tensor, on the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.core.neuron import NeuronState, Propagators
from repro_torch.kernels import ell_deliver as _ell
from repro_torch.kernels import flash_attention as _attn
from repro_torch.kernels import lif_deliver as _fused
from repro_torch.kernels import lif_update as _lif
from repro_torch.kernels import spike_deliver as _dense


def lif_update(state: NeuronState, prop: Propagators, in_ex: torch.Tensor,
               in_in: torch.Tensor, i_dc: torch.Tensor):
    """LIF update (K1).  Drop-in for ``core.neuron.lif_step``."""
    V, I_ex, I_in, refrac, spiked = _lif.lif_update(
        state.V, state.I_ex, state.I_in, state.refrac, in_ex.contiguous(),
        in_in.contiguous(), i_dc.contiguous(), prop=prop)
    return NeuronState(V, I_ex, I_in, refrac), spiked


def gated_spike_matvec(s: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Activity-gated dense matvec (K5): ``s`` [P], ``W`` [D, P, N] ->
    ``Σ_p s[p]·W[d, p, n]`` [D, N] float32."""
    return _dense.gated_spike_matvec(s, W)


def ell_deliver(ring: torch.Tensor, tables, spiked: torch.Tensor, t,
                n_exc: int, spike_budget: int):
    """Sparse-ELL delivery (K2), in place.  Returns ``(ring, overflow)``,
    like ``DeliveryStrategy.deliver``."""
    ring, _, overflow = _ell.ell_deliver(
        ring, tables.targets, tables.weights, tables.dbins, spiked, t,
        n_exc, spike_budget)
    return ring, overflow


def _contiguous(x):
    return None if x is None else x.contiguous()


def lif_deliver(state: NeuronState, ring: torch.Tensor, t,
                spiked_prev: torch.Tensor, tables, prop: Propagators,
                ext_cnt, i_dc: torch.Tensor, *, n_exc: int,
                spike_budget: int, w_ext: float, overflow: torch.Tensor):
    """Fused step (K3): deliver ``spiked_prev`` at phase ``t - 1``, then
    integrate step ``t``.  The reference's arguments, but the drive as the
    step draws it: ``ext_cnt`` the float32 spike counts (None: no spike
    drive) and ``w_ext`` their weight; ``overflow`` the running overflow.
    Returns ``(neuron', ring, spiked, t + 1, overflow')``, the overflow
    having gained the delivered step's budget excess."""
    (ring, V, I_ex, I_in, refrac, spiked, _, overflow,
     t) = _fused.lif_deliver(
        ring, tables.targets, tables.weights, tables.dbins, spiked_prev,
        state.V, state.I_ex, state.I_in, state.refrac, _contiguous(ext_cnt),
        i_dc.contiguous(), t, overflow, n_exc=n_exc, budget=spike_budget,
        prop=prop, w_ext=w_ext)
    return NeuronState(V, I_ex, I_in, refrac), ring, spiked, t, overflow


def lif_deliver_plastic(state: NeuronState, ring: torch.Tensor, t,
                        spiked_prev: torch.Tensor, tables, pmask, ps,
                        prop: Propagators, ext_cnt, i_dc: torch.Tensor, *,
                        n_exc: int, spike_budget: int, w_ext: float,
                        overflow: torch.Tensor, coef, trace: bool = True):
    """Fused plastic step (K4): deliver ``spiked_prev`` at phase ``t - 1``
    through the live table ``ps.weights`` (depressing its plastic entries
    ``pmask`` in place), update the traces, then integrate step ``t``; the
    drive and the counters as for :func:`lif_deliver`.  Returns
    ``(neuron', ring, spiked, ps', ids, t + 1, overflow')``; ``ps'`` is a
    ``PlasticState`` of the same table and the new traces, ``ids`` the
    delivered ids for ``stdp_pot_clip``."""
    (ring, w, V, I_ex, I_in, refrac, spiked, x_pre, x_post, ids, overflow,
     t) = _fused.lif_deliver_plastic(
        ring, tables.targets, ps.weights, tables.dbins, pmask, spiked_prev,
        state.V, state.I_ex, state.I_in, state.refrac, _contiguous(ext_cnt),
        i_dc.contiguous(), ps.x_pre, ps.x_post, t, overflow, n_exc=n_exc,
        budget=spike_budget, prop=prop, w_ext=w_ext, coef=coef, trace=trace)
    return (NeuronState(V, I_ex, I_in, refrac), ring, spiked,
            ps._replace(weights=w, x_pre=x_pre, x_post=x_post), ids, t,
            overflow)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None,
                    q_offset: int = 0) -> torch.Tensor:
    """Blocked GQA attention (K6): ``q`` [B, Hq, T, D], ``k``/``v``
    [B, Hkv, S, D] -> [B, Hq, T, D].  The causal mask is top-left aligned,
    as in the TPU kernel (not ``ref.mha_ref``'s bottom-right one), shifted
    by ``q_offset`` (query 0's position; 0 in the TPU kernel)."""
    return _attn.flash_attention(q, k, v, causal=causal, scale=scale,
                                 q_offset=q_offset)
