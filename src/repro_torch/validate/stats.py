"""Streaming spike statistics: the moment carry of the ``spike_stats``
stream probe.

The port's counterpart of ``repro/validate/stats.py:60-128``: per sampled
neuron the spike count, the last spike's step and the ISI count, sum and
sum of squares; per closed count bin the binned count vector's running sum
and outer product.  ``init_carry`` / ``update_carry`` are tensor functions
that run inside the step loop (and inside a captured CUDA graph: nothing
reads back to the host), with the reference's float32 arithmetic in the
reference's order, so the carry equals the JAX package's bit for bit.
``finalize``, ``RasterAccumulator`` and ``pool_carries`` wait for the
validation slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SpikeStatsCarry(NamedTuple):
    """Moment accumulator over ``Ns`` sampled neurons, on the device."""
    steps: torch.Tensor       # [] int32   updates consumed so far
    last_spike: torch.Tensor  # [Ns] int32 step of last spike, -1 = never
    n_spikes: torch.Tensor    # [Ns] int32
    isi_count: torch.Tensor   # [Ns] int32 completed inter-spike intervals
    isi_sum: torch.Tensor     # [Ns] f32   sum of ISIs (in steps)
    isi_sumsq: torch.Tensor   # [Ns] f32   sum of squared ISIs
    bin_acc: torch.Tensor     # [Ns] int32 open (partial) count bin
    n_bins: torch.Tensor      # [] int32   closed bins
    bin_sum: torch.Tensor     # [Ns] f32   sum of closed-bin count vectors
    bin_outer: torch.Tensor   # [Ns, Ns] f32 sum of their outer products


def init_carry(n_sample: int, device=None) -> SpikeStatsCarry:
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return SpikeStatsCarry(
        steps=i32(), last_spike=torch.full((n_sample,), -1,
                                           dtype=torch.int32, device=device),
        n_spikes=i32(n_sample), isi_count=i32(n_sample),
        isi_sum=f32(n_sample), isi_sumsq=f32(n_sample),
        bin_acc=i32(n_sample), n_bins=i32(), bin_sum=f32(n_sample),
        bin_outer=f32(n_sample, n_sample))


def update_carry(carry: SpikeStatsCarry, spiked: torch.Tensor,
                 bin_steps: int) -> SpikeStatsCarry:
    """Absorb one step's sampled spike vector (``[Ns]`` bool).  A count bin
    closes every ``bin_steps`` updates; the trailing partial bin stays
    open.  The outer product is computed every step and kept only on a
    closing one (the reference's ``lax.cond``; a graph has no branch)."""
    t = carry.steps
    spk = spiked.to(torch.bool)
    spk_i = spk.to(torch.int32)

    new_isi = spk & (carry.last_spike >= 0)
    isi = (t - carry.last_spike).to(torch.float32)
    isi_add = torch.where(new_isi, isi, 0.0)

    steps = t + 1
    close = torch.remainder(steps, bin_steps) == 0
    bin_acc = carry.bin_acc + spk_i
    x = bin_acc.to(torch.float32)
    bin_outer = torch.where(close, carry.bin_outer + torch.outer(x, x),
                            carry.bin_outer)

    return SpikeStatsCarry(
        steps=steps,
        last_spike=torch.where(spk, t, carry.last_spike),
        n_spikes=carry.n_spikes + spk_i,
        isi_count=carry.isi_count + new_isi.to(torch.int32),
        isi_sum=carry.isi_sum + isi_add,
        isi_sumsq=carry.isi_sumsq + isi_add * isi,
        bin_acc=torch.where(close, torch.zeros_like(bin_acc), bin_acc),
        n_bins=carry.n_bins + close.to(torch.int32),
        bin_sum=torch.where(close, carry.bin_sum + x, carry.bin_sum),
        bin_outer=bin_outer)
