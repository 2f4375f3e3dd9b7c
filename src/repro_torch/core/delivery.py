"""Spike-delivery strategies: a protocol plus a registry.

The port's counterpart of ``repro.core.delivery``, with ``event``, ``ell``
and ``dense``.  Every strategy writes into ``ring[D, 2, N+1]`` (channel 0/1
= excitatory/inhibitory arrivals, one trailing dump column for padded
entries), in place.  ``event`` and ``ell`` use the padded ELL
out-adjacency with one sentinel source row at index N.

* ``event`` -- the reference's ``deliver_event`` (:func:`deliver_event`):
  ordered id compaction, row gather and one ``index_add_`` (the JAX
  package leaves it to XLA, so the port leaves it to PyTorch).
* ``ell`` -- the same tables, rows padded to ``block_k = 128``; delivered
  by kernel K2 (``kernels/ell_deliver``) when the resolved policy says
  ``deliver="kernel"``, by the plain version of ``event`` otherwise
  (``reference``).
* ``dense`` -- the delay-binned table ``W[D, N_pre, N_post]``, built on
  the session's device (``connectivity.dense_table``).  Bin-major and
  delivered by kernel K5 (``kernels/spike_deliver``) when the policy says
  ``deliver="kernel"``; source-major ``W_ex``/``W_in`` and delivered by
  two ``torch.matmul`` GEMVs when it says ``deliver="matmul"``.  No spike
  budget, so no overflow; no live-weight path.

``deliver_ids`` also returns the step's compacted ids, which the plastic
path hands to the STDP update instead of compacting the spikes again.
``localize`` is a strategy's shard transform for the sharded backend:
``event`` and ``ell`` regroup their ELL tables by target-owning rank
(``distributed.localize_ell``); ``dense`` has none and raises.
The phase ``t`` every strategy takes is the step counter, a 0-d int32
tensor on the ring's device; nothing reads it back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import kernel_policy as kpol
from repro_torch.core.connectivity import dense_bytes_estimate, dense_table
from repro_torch.core.params import FULL_MEAN_RATES
from repro_torch.kernels.ell_deliver import ell_deliver, ell_deliver_plain
from repro_torch.kernels.spike_deliver import (dense_deliver,
                                               dense_deliver_plain, rolled)


class DeliveryOverflowError(RuntimeError):
    """Raised (``SimConfig.strict_delivery``) when spikes exceeded the
    per-step ``spike_budget`` and were dropped."""


class EventTables(NamedTuple):
    """Padded ELL out-adjacency, plus one sentinel row at index N."""
    targets: torch.Tensor   # [N+1, K] int32 in [0, N]; N == dump
    weights: torch.Tensor   # [N+1, K] float32
    dbins: torch.Tensor     # [N+1, K] int32 >= 1


class DenseTables(NamedTuple):
    """Signed delay-binned weights, in one of two layouts.

    Bin-major ``W[D, N_pre, N_post]`` feeds kernel K5.  Source-major
    ``W_ex[n_exc, D*N]`` / ``W_in[N - n_exc, D*N]``, split at the Dale
    boundary, feeds two GEMVs; here they are the two row blocks of one
    ``[N, D*N]`` table, not two copies.
    """
    W: Optional[torch.Tensor] = None        # [D, N_pre, N_post] bin-major
    W_ex: Optional[torch.Tensor] = None     # [n_exc, D * N_post]
    W_in: Optional[torch.Tensor] = None     # [N - n_exc, D * N_post]


def make_event_tables(targets: np.ndarray, weights: np.ndarray,
                      dbins: np.ndarray, device,
                      k_pad: Optional[int] = None) -> EventTables:
    """Pad the rows to ``k_pad`` entries (target N, weight 0, delay bin 1),
    append the sentinel source row (every entry the dump column with
    weight 0) and move the tables to ``device``.  One host copy per table,
    which matters at full scale (2.1 GB each)."""
    n, k = targets.shape
    k_pad = k if k_pad is None else k_pad

    def padded(a, fill):
        out = np.full((n + 1, k_pad), fill, a.dtype)
        out[:n, :k] = a
        return torch.from_numpy(out).to(device)
    return EventTables(targets=padded(targets, n), weights=padded(weights, 0),
                       dbins=padded(dbins, 1))


def deliver_event(ring: torch.Tensor, tables: EventTables,
                  spiked: torch.Tensor, t, n_exc: int, spike_budget: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Event-driven delivery, the ``event`` strategy's: the lowest
    ``spike_budget`` spiking ids' rows added into ``ring`` (in place) at
    slot ``(t + dbin) % D``, channel by the source's side of ``n_exc``.
    Returns ``(ring, n_overflow)``, the reference's
    (``repro/core/delivery.py:110``)."""
    ring, _, overflow = ell_deliver_plain(ring, tables.targets,
                                          tables.weights, tables.dbins,
                                          spiked, t, n_exc, spike_budget)
    return ring, overflow


def deliver_dense(ring: torch.Tensor, tables: DenseTables,
                  spiked: torch.Tensor, t, n_exc: int,
                  kernel: bool = False):
    """Delay-binned dense delivery, ``ring`` updated in place.  Returns
    ``(ring, overflow)``; the overflow is always 0 (no spike budget).

    Each channel's update is summed from zero (``upd_ex`` over
    ``s[:n_exc]``, ``upd_in`` over ``s[n_exc:]``), and bin ``d`` lands in
    slot ``(t + d) % D``.  The bin-major table goes to K5 with ``kernel``
    (on CPU tensors its plain version, as every wrapper does), else to
    the plain version; the source-major one to two GEMVs.
    """
    zero = torch.zeros((), dtype=torch.int32, device=ring.device)
    if tables.W is None:
        if kernel:
            raise ValueError(
                "the dense kernel (K5) needs the bin-major W[D, P, N] "
                "layout, but these DenseTables hold the split GEMM layout "
                "-- rebuild the tables under a KernelPolicy with "
                "deliver='kernel' (DenseDelivery.prepare)")
        D, _, n_cols = ring.shape
        n = spiked.shape[0]
        s = spiked.to(tables.W_ex.dtype)
        upd_ex = torch.matmul(s[:n_exc], tables.W_ex).view(D, n)
        upd_in = torch.matmul(s[n_exc:], tables.W_in).view(D, n)
        upd = torch.stack([upd_ex, upd_in], dim=1).to(ring.dtype)
        ring[:, :, :n] += rolled(upd, t)
        return ring, zero
    (dense_deliver if kernel else dense_deliver_plain)(
        ring, tables.W, spiked, t, n_exc)
    return ring, zero


def auto_spike_budget(c, dt: float, safety: float = 8.0,
                      quantum: int = 128) -> int:
    """Rate-derived per-step spike capacity: expected spikes per step at
    the full-scale reference rates times ``safety``, rounded up to
    ``quantum`` and capped at the padded network size."""
    pop_sizes = np.asarray(c.pop_sizes)
    if pop_sizes.shape[0] == FULL_MEAN_RATES.shape[0]:
        expected = float((pop_sizes * FULL_MEAN_RATES).sum()) * dt * 1e-3
    else:
        expected = c.n_total * float(FULL_MEAN_RATES.max()) * dt * 1e-3
    budget = max(quantum, math.ceil(expected * safety / quantum) * quantum)
    n_cap = math.ceil(c.n_total / quantum) * quantum
    return int(min(budget, n_cap))


def _require_budget(cfg) -> int:
    if cfg.spike_budget is None:
        raise ValueError(
            "SimConfig.spike_budget is unresolved; call repro_torch.core."
            "engine.resolve_sim_config(cfg, connectome, device) first")
    return int(cfg.spike_budget)


class DeliveryStrategy:
    """One spike-propagation mechanism: ``prepare`` builds the device
    tables on the host, ``deliver`` scatters one step's spikes."""

    name: str = "abstract"
    supports_live_weights: bool = False

    def prepare(self, c, cfg, device) -> Any:
        raise NotImplementedError

    def localize(self, c, n_dev: int, k_loc: Optional[int] = None,
                 device="cpu"):
        """Shard transform for the sharded backend: regroup the tables by
        target-owning rank.  Strategies without a distributed layout
        raise ``NotImplementedError``."""
        raise NotImplementedError(
            f"delivery strategy {self.name!r} has no shard transform")

    @property
    def supports_sharding(self) -> bool:
        return False

    def live_tables(self, tables: Any, weights: torch.Tensor) -> Any:
        """``tables`` with the live plastic ``weights`` (the strategy's own
        ``[N+1, K]`` layout, kept padded: the reference pads them every
        step, ``delivery.py:436``) swapped in: a re-wrap, never a copy."""
        if not self.supports_live_weights:
            raise NotImplementedError(
                f"delivery strategy {self.name!r} has no live-weight path "
                f"(live_tables); plasticity requires 'event' or 'ell'")
        return tables._replace(weights=weights)

    def deliver_ids(self, ring: torch.Tensor, tables: Any,
                    spiked: torch.Tensor, t, n_exc: int, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Scatter one step's spikes.  Returns (ring, ids, n_overflow):
        ``ids`` [budget] int32 are the delivered ids, ascending, then N."""
        raise NotImplementedError

    def deliver(self, ring: torch.Tensor, tables: Any, spiked: torch.Tensor,
                t, n_exc: int, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scatter one step's spikes. Returns (ring, n_overflow)."""
        ring, _, overflow = self.deliver_ids(ring, tables, spiked, t, n_exc,
                                             cfg)
        return ring, overflow


REGISTRY: Dict[str, DeliveryStrategy] = {}


def register(cls: Type[DeliveryStrategy]) -> Type[DeliveryStrategy]:
    """Class decorator: instantiate and register under ``cls.name``."""
    if not getattr(cls, "name", None) or cls.name == "abstract":
        raise ValueError(f"{cls.__name__} needs a concrete .name")
    if cls.name in REGISTRY:
        raise ValueError(f"delivery strategy {cls.name!r} is already "
                         f"registered")
    REGISTRY[cls.name] = cls()
    return cls


def get_strategy(name: str) -> DeliveryStrategy:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown delivery strategy {name!r}; "
                         f"available: {available_strategies()}") from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


@register
class EventDelivery(DeliveryStrategy):
    """Budgeted event-driven gather + one ``index_add_``."""

    name = "event"
    supports_live_weights = True

    def prepare(self, c, cfg, device) -> EventTables:
        return make_event_tables(c.targets, c.weights, c.dbins, device)

    def localize(self, c, n_dev, k_loc=None, device="cpu"):
        from repro_torch.core.distributed import localize_ell
        return localize_ell(c, n_dev, k_loc, device=device)

    @property
    def supports_sharding(self) -> bool:
        return True

    def deliver_ids(self, ring, tables, spiked, t, n_exc, cfg):
        return ell_deliver_plain(ring, tables.targets, tables.weights,
                                 tables.dbins, spiked, t, n_exc,
                                 _require_budget(cfg))


@register
class EllDelivery(DeliveryStrategy):
    """Sparse-ELL delivery backed by kernel K2 (``kernels/ell_deliver``)."""

    name = "ell"
    block_k = 128            # ELL row pad (the reference's lane-aligned K)
    supports_live_weights = True

    def k_pad(self, k: int) -> int:
        return max(self.block_k, -(-k // self.block_k) * self.block_k)

    def prepare(self, c, cfg, device) -> EventTables:
        """The reference's pad to ``block_k`` (delivery.py:404-417)."""
        return make_event_tables(c.targets, c.weights, c.dbins, device,
                                 k_pad=self.k_pad(c.targets.shape[1]))

    def localize(self, c, n_dev, k_loc=None, device="cpu"):
        # the sharded step delivers through the localized columns by K2's
        # local-ring form, whatever the row pad
        from repro_torch.core.distributed import localize_ell
        return localize_ell(c, n_dev, k_loc, device=device)

    @property
    def supports_sharding(self) -> bool:
        return True

    def deliver_ids(self, ring, tables, spiked, t, n_exc, cfg):
        pol = kpol.policy_of(cfg)
        k2 = pol is not None and pol.deliver == "kernel"
        return (ell_deliver if k2 else ell_deliver_plain)(
            ring, tables.targets, tables.weights, tables.dbins, spiked, t,
            n_exc, _require_budget(cfg))


@register
class DenseDelivery(DeliveryStrategy):
    """Delay-binned matrix delivery (O(N^2) memory, guarded)."""

    name = "dense"

    def prepare(self, c, cfg, device, dtype=torch.float32) -> DenseTables:
        """The layout the policy asks for: bin-major for K5, source-major
        otherwise.  Raises past ``connectivity.DENSE_MAX_BYTES`` before
        allocating anything."""
        if self._kernel(cfg):
            return DenseTables(W=dense_table(c, device).to(dtype))
        Wt = dense_table(c, device, source_major=True).to(dtype)
        return DenseTables(W_ex=Wt[:c.n_exc], W_in=Wt[c.n_exc:])

    def memory_bytes(self, c, itemsize: int = 4) -> int:
        return dense_bytes_estimate(c, itemsize)

    @staticmethod
    def _kernel(cfg) -> bool:
        pol = kpol.policy_of(cfg)
        return pol is not None and pol.deliver == "kernel"

    def deliver(self, ring, tables, spiked, t, n_exc, cfg):
        return deliver_dense(ring, tables, spiked, t, n_exc,
                             kernel=self._kernel(cfg))
