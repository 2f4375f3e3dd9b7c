"""K2: sparse-ELL spike delivery, the delivery-only form of the fused
step's kernel (``csrc/lif_deliver.cu``): its entry point and phases.  Its
plain versions and its launch live in ``lif_deliver`` with the kernel's
other forms, and are named here too.

Replaces ``repro/kernels/ell_deliver.py:ell_deliver_pallas`` together with
the id compaction of ``repro/kernels/ops.py:ell_deliver``.  The step's
spiking ids are compacted in order (the lowest ``budget`` ids ascending,
then the sentinel row N), their ELL rows gathered, and every (target,
weight, delay-bin) triple added into ``ring[(t + dbin) % D, ch, target]``
with ``ch = sid >= n_exc`` (Dale's law).  ``t`` is the step counter, a 0-d
int32 tensor on the ring's device, which the kernel reads there.

The ring is updated **in place** (the port keeps one 28 MB ring per
session instead of a new one per step).  It has a column per target and a
trailing dump column, ``[D, 2, n_tgt + 1]``: ``n_tgt`` is ``N`` on one
device, and in the local-ring form (``n_tgt=``, the sharded step's
delivery, ``core/distributed``) the rank's neuron count, while the spike
vector and the tables' rows still span the whole world's ``N``.  The
plain version adds in the reference's ``deliver_event`` order (s-major,
k-minor) through ``index_add_``; the CUDA kernel adds with float atomics
in no fixed order, so on the card the ring agrees with the plain version
to a tolerance, while ids and overflow are exact.  Neither reads
anything back to the host.

On ``meta`` tensors (``launch.dryrun``) a call gives its outputs' shapes
and reports to ``perf.step_analysis`` what a launch delivering the
budget's rows would move (a meta tensor holds no spikes); nothing runs.

On the card a call is one cooperative launch (``lif_deliver.deliver``):
the ordered compaction by decoupled look-back over the workspace that K3
and K4 use, a grid sync, then the scatter split evenly by entries.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lif_deliver as K3
from repro_torch.kernels.lif_deliver import (  # noqa: F401 (K2's names)
    compact_ids_plain, ell_deliver_plain, scatter_rows_plain)
from repro_torch.perf.step_analysis import note_kernel

#: what lies between a block's consecutive stamps of K2's stamped launch
#: (``lif_deliver.stamps_buffer``): the fused step's first five phases
PHASES = K3.PHASES[:5]


def ell_deliver(ring, targets, weights, dbins, spiked, t, n_exc: int,
                budget: int, *, n_tgt=None, stamps=None):
    """Returns ``(ring, ids, overflow)``; ``ring`` [D, 2, n_tgt+1] f32 is
    updated in place, tables are ``[N+1, K_pad]`` with sentinel row N and
    target ``n_tgt`` the dump column; ``n_tgt`` is ``N`` unless given (the
    local-ring form, whose launches count as ``ell_deliver_local``).
    ``stamps`` (``lif_deliver.stamps_buffer``, on the card only) selects
    the stamped kernel, for a phase table."""
    if ring.device.type == "cpu":
        if stamps is not None:
            raise ValueError("ell_deliver: stamps are the kernel's, on the "
                             "card")
        n = spiked.shape[0]
        K3.check_ring("ell_deliver", ring, n, n if n_tgt is None else n_tgt)
        return ell_deliver_plain(ring, targets, weights, dbins, spiked, t,
                                 n_exc, budget)
    if ring.device.type == "meta":
        n_rows = min(budget, spiked.shape[0])
        entries = n_rows * targets.shape[1]
        note_kernel("ell_deliver" if n_tgt is None else "ell_deliver_local",
                    nbytes=spiked.shape[0] + 4 * budget + 4
                    + entries * (12 + 8), flops=3 * entries)
        return (ring, torch.empty(budget, dtype=torch.int32, device="meta"),
                torch.empty((), dtype=torch.int32, device="meta"))
    return K3.deliver(ring, targets, weights, dbins, spiked, t, n_exc=n_exc,
                      budget=budget, n_tgt=n_tgt, stamps=stamps)
