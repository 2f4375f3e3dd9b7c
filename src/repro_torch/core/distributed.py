"""Sharded microcircuit simulation: NEST's distribution scheme over
``torch.distributed``.

The port's counterpart of ``repro.core.distributed`` (``:34-304``).
Ownership follows NEST: each rank owns the *state* and the *incoming
synapses* of a contiguous slice of ``n_loc`` neurons.  One step of a rank:

  update      the rank's drive, then the LIF step over its ``[n_loc]``
              slice (K1 on the card), which consumes the slot it read
  communicate an all-gather of the ranks' spike vectors into the global
              ``[N_pad]`` registry (NEST: MPI_Allgather of the spike
              register)
  deliver     the *global* spikes through the rank's column block of the
              tables into its *local* ring (K2's local-ring form on the
              card); the overflow is the global one, ``n_spk - budget``,
              the same on every rank

The connectome is laid out rank-major (``localize_ell``): for every source
neuron its synapses are grouped by owning rank and padded to ``k_loc`` per
rank, so rank r's table is the contiguous column block ``[N_pad+1,
k_loc]`` of one global ``[N_pad+1, n_dev * k_loc]`` table, with targets
localised to ``0..n_loc-1`` and sentinel ``n_loc`` (the ring's dump
column).  ``N_pad`` rounds ``N`` up to a multiple of ``n_dev``; the padding
neurons start at ``V_reset``, get no drive, never spike, and no synapse
names them.

The step takes the gather as an argument: a backend passes its process
group's collective (``repro_torch.launch.mesh``), a world of one the
identity.  :func:`step_shards` holds a whole world in one process, its
gather a concatenation (for tests, and for a card that has to show the
shard layout at full width alone).  The population counts come from the
gathered registry, reduced over ``pop_of`` padded with a sentinel
population (:func:`padded_pop_of`), so they are the same on every rank.

The rest of the reference's module (``:101-137, 311-397``) is here too:

* the abstract layouts of the dry run (``launch/dryrun``):
  :func:`abstract_sharded_tables`, :func:`abstract_state` and
  :func:`abstract_dense` are tensors on ``meta`` (shapes and dtypes, no
  storage) with the reference's shapes and dtypes; where the reference
  holds PRNG keys (``[n_dev, 2]`` / ``[2]`` uint32), the layouts hold the
  generators' states (``[n_dev, 16]`` / ``[16]`` uint8, a CUDA
  generator's), as the sharded checkpoint does;
* the dense strategy sharded 2-D: :func:`dense_shardings` places
  ``W[D, N, N]`` (dim 1, the sources, over every mesh dim but ``model``;
  dim 2, the targets, over ``model``) and replicates the ``[N]`` state;
  :func:`make_dense_step` is the step each rank runs over its
  ``W[:, pre_block, post_block]``, whose local product is K5
  (``kernels.spike_deliver.gated_spike_matvec``), the partial sums
  all-reduced over the ``data`` group and all-gathered over ``model``
  (``launch.mesh.World2d``).
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import kernel_policy as kpol
from repro_torch.core.engine import Network, SimState, update_phase
from repro_torch.core.neuron import NeuronState, Propagators
from repro_torch.kernels.ell_deliver import ell_deliver, ell_deliver_plain
from repro_torch.kernels.lif_deliver import slot_index
from repro_torch.kernels.spike_deliver import gated_spike_matvec, rolled

#: bytes of a CUDA generator's state (``torch.Generator.get_state()``): the
#: abstract layouts' stand-in for the reference's PRNG key
GENERATOR_STATE_BYTES = 16


class ShardedTables(NamedTuple):
    """The localised ELL tables: the world's ``[N_pad+1, n_dev * k_loc]``
    and ``[N_pad]`` (:func:`localize_ell`), or one rank's block of them,
    ``[N_pad+1, k_loc]`` and ``[n_loc]`` (:func:`shard_of`)."""
    targets: torch.Tensor   # int32, localised; sentinel n_loc
    weights: torch.Tensor   # float32
    dbins: torch.Tensor     # int32 >= 1
    k_ext: torch.Tensor     # float32
    i_dc: torch.Tensor      # float32


class ShardedSimState(NamedTuple):
    """One rank's state.  The reference keeps one PRNG key per device
    (``key``); a rank here draws from its ``generator``."""
    V: torch.Tensor         # [n_loc]
    I_ex: torch.Tensor
    I_in: torch.Tensor
    refrac: torch.Tensor    # int32
    ring: torch.Tensor      # [D, 2, n_loc + 1], updated in place
    t: torch.Tensor         # 0-d int32 step counter
    generator: Optional[torch.Generator]
    overflow: torch.Tensor  # 0-d int32, cumulative, global


def world_layout(n: int, n_dev: int) -> Tuple[int, int]:
    """``(n_pad, n_loc)``: ``n`` rounded up to a multiple of ``n_dev``, and
    each rank's share of it."""
    n_pad = -(-n // n_dev) * n_dev
    return n_pad, n_pad // n_dev


def localize_ell(c, n_dev: int, k_loc: Optional[int] = None,
                 device="cpu") -> Tuple[ShardedTables, dict]:
    """Regroup the connectome's ELL table by target-owning rank, on
    ``device``.  Returns the world's tables and ``meta`` (``n_pad``,
    ``n_loc``, ``k_loc``, ``n_dev``), bit for bit the reference's
    (``repro/core/distributed.py:43-98``).

    The reference orders the real entries by ``lexsort((tgt_local, dev,
    src))``.  As ``dev * n_loc + tgt_local == tgt``, that is one stable
    sort on the key ``src * N_pad + tgt``: entries of one (source, rank)
    cell end up by local target, and multapses to one target keep their
    column order.  A ``bincount`` over ``src * n_dev + dev`` gives each
    cell's entries, so each entry's column in its cell is its position
    less its cell's start.  ``k_loc`` below the largest cell raises
    ``ValueError``.
    """
    n, k = c.n_total, c.targets.shape[1]
    n_pad, n_loc = world_layout(n, n_dev)
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    tgt = on(c.targets).reshape(-1)
    at = torch.nonzero(tgt < n).squeeze(1)         # real entries, in order
    tgt = tgt[at].to(torch.int64)
    src = torch.div(at, k, rounding_mode="floor")
    order = torch.sort(src * n_pad + tgt, stable=True).indices
    at, src, tgt = at[order], src[order], tgt[order]
    del order
    dev = torch.div(tgt, n_loc, rounding_mode="floor")
    cell = src * n_dev + dev
    tgt_local = (tgt - dev * n_loc).to(torch.int32)
    del src, tgt, dev
    counts = torch.bincount(cell, minlength=n * n_dev)
    k_max = int(counts.max()) if counts.numel() else 1
    if k_loc is None:
        k_loc = k_max
    elif k_loc < k_max:
        raise ValueError(f"k_loc={k_loc} < max {k_max}")
    starts = torch.cumsum(counts, 0) - counts
    slot = cell * k_loc + (torch.arange(cell.shape[0], device=cell.device)
                           - starts[cell])
    del counts, starts, cell
    size = (n_pad + 1) * n_dev * k_loc
    T = torch.full((size,), n_loc, dtype=torch.int32, device=device)
    T[slot] = tgt_local
    del tgt_local
    W = torch.zeros(size, dtype=torch.float32, device=device)
    W[slot] = on(c.weights).reshape(-1)[at]
    D = torch.ones(size, dtype=torch.int32, device=device)
    D[slot] = on(c.dbins).reshape(-1)[at]
    del slot, at

    def padded(a):
        out = torch.zeros(n_pad, dtype=torch.float32, device=device)
        out[:n] = on(np.asarray(a, np.float32))
        return out
    shape = (n_pad + 1, n_dev * k_loc)
    tables = ShardedTables(targets=T.view(shape), weights=W.view(shape),
                           dbins=D.view(shape), k_ext=padded(c.k_ext),
                           i_dc=padded(c.i_dc))
    meta = {"n_pad": n_pad, "n_loc": n_loc, "k_loc": k_loc, "n_dev": n_dev}
    return tables, meta


def shard_of(tables: ShardedTables, meta: dict, rank: int) -> ShardedTables:
    """Rank ``rank``'s block of the world's tables: its contiguous
    ``[N_pad+1, k_loc]`` columns (a copy, but for a world of one) and its
    ``[n_loc]`` slices of ``k_ext`` and ``i_dc``."""
    n_dev, k_loc, n_loc = meta["n_dev"], meta["k_loc"], meta["n_loc"]
    if not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} outside a world of {n_dev}")
    lo = rank * n_loc

    def block(x):
        if n_dev == 1:
            return x
        return x.view(x.shape[0], n_dev, k_loc)[:, rank].contiguous()
    return ShardedTables(
        targets=block(tables.targets), weights=block(tables.weights),
        dbins=block(tables.dbins), k_ext=tables.k_ext[lo:lo + n_loc],
        i_dc=tables.i_dc[lo:lo + n_loc])


def padded_pop_of(pop_of, n_pad: int, n_pops: int, device) -> torch.Tensor:
    """The global population index ``[n_pad]`` int32, the padding neurons
    in the sentinel population ``n_pops`` (still sorted), so a reduction
    of the gathered registry over populations drops them."""
    out = np.full(n_pad, n_pops, np.int32)
    out[:len(pop_of)] = np.asarray(pop_of)
    return torch.as_tensor(out, device=device)


def shard_network(shard: ShardedTables, pop_of: torch.Tensor) -> Network:
    """The ``Network`` a rank's step reads: its tables, its ``k_ext`` and
    ``i_dc`` slices, and the padded global ``pop_of`` the probes reduce
    the gathered registry over."""
    return Network(tables=shard, k_ext=shard.k_ext, i_dc=shard.i_dc,
                   pop_of=pop_of)


def init_shard(V: torch.Tensor, d_bins: int, meta: dict, rank: int,
               generator: Optional[torch.Generator],
               v_pad: float) -> ShardedSimState:
    """Rank ``rank``'s fresh state from the world's initial ``V`` ``[N]``
    (padded with ``v_pad``, the reset potential): currents, refractory
    counters, ring and counters 0."""
    n_loc, lo = meta["n_loc"], rank * meta["n_loc"]
    dev = V.device
    full = torch.full((meta["n_pad"],), v_pad, dtype=torch.float32,
                      device=dev)
    full[:V.shape[0]] = V
    z = lambda dtype: torch.zeros(n_loc, dtype=dtype, device=dev)
    return ShardedSimState(
        V=full[lo:lo + n_loc].clone(), I_ex=z(torch.float32),
        I_in=z(torch.float32), refrac=z(torch.int32),
        ring=torch.zeros((d_bins, 2, n_loc + 1), dtype=torch.float32,
                         device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        generator=generator,
        overflow=torch.zeros((), dtype=torch.int32, device=dev))


def update_shard(st: ShardedSimState, net: Network, prop, cfg, w_ext: float,
                 drive) -> Tuple[ShardedSimState, torch.Tensor]:
    """The rank's update: its drive, the LIF step over its slice (K1 when
    the policy says kernels) and the consumed slot, by the engine's own
    ``update_phase``.  Returns ``(state, spiked [n_loc])``."""
    sim = SimState(NeuronState(st.V, st.I_ex, st.I_in, st.refrac), st.ring,
                   st.t, st.generator, st.overflow)
    sim, spiked = update_phase(sim, net, prop, cfg, w_ext, st.V.shape[0],
                               drive)
    nr = sim.neuron
    return st._replace(V=nr.V, I_ex=nr.I_ex, I_in=nr.I_in,
                       refrac=nr.refrac), spiked


def deliver_shard(st: ShardedSimState, net: Network, cfg,
                  spiked_global: torch.Tensor, n_exc: int) -> ShardedSimState:
    """Deliver the gathered registry ``[N_pad]`` through the rank's block
    into its local ring, at phase ``t``, then advance ``t``: K2's
    local-ring form when the policy delivers by kernel, its plain version
    (the reference's scatter order) otherwise."""
    tb = net.tables
    pol = kpol.policy_of(cfg)
    budget = int(cfg.spike_budget)
    if pol is not None and pol.deliver == "kernel":
        ring, _, ovf = ell_deliver(st.ring, tb.targets, tb.weights, tb.dbins,
                                   spiked_global, st.t, n_exc, budget,
                                   n_tgt=st.V.shape[0])
    else:
        ring, _, ovf = ell_deliver_plain(st.ring, tb.targets, tb.weights,
                                         tb.dbins, spiked_global, st.t,
                                         n_exc, budget)
    return st._replace(ring=ring, t=st.t + 1, overflow=st.overflow + ovf)


def sharded_step(st: ShardedSimState, net: Network, prop, cfg, *,
                 w_ext: float, n_exc: int, drive,
                 gather: Callable[[torch.Tensor], torch.Tensor]
                 ) -> Tuple[ShardedSimState, torch.Tensor]:
    """One step of one rank (``make_sharded_step``'s body,
    ``repro/core/distributed.py:197-273``): update, ``gather`` of the
    spike vectors into the ``[N_pad]`` registry, delivery.  Returns the
    state and the gathered registry."""
    st, spiked = update_shard(st, net, prop, cfg, w_ext, drive)
    spiked_global = gather(spiked)
    return deliver_shard(st, net, cfg, spiked_global, n_exc), spiked_global


def step_shards(states: Sequence[ShardedSimState], nets: Sequence[Network],
                prop, cfg, *, w_ext: float, n_exc: int, drives: Sequence
                ) -> Tuple[List[ShardedSimState], torch.Tensor]:
    """One step of a whole world held in one process: every rank's update,
    the registry as the concatenation of their spikes, every rank's
    delivery.  Returns the states and the registry."""
    ups = [update_shard(st, net, prop, cfg, w_ext, drive)
           for st, net, drive in zip(states, nets, drives, strict=True)]
    spiked_global = torch.cat([spk for _, spk in ups])
    return [deliver_shard(st, net, cfg, spiked_global, n_exc)
            for (st, _), net in zip(ups, nets)], spiked_global


def rank_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s generator seed in a world of more than one: numpy's
    ``SeedSequence([seed, rank])``, its first 63-bit word.  (The reference
    folds the rank into the session's key with ``jax.random.fold_in``,
    which a torch generator cannot match.)"""
    word = np.random.SeedSequence([int(seed), int(rank)]).generate_state(
        1, np.uint64)[0]
    return int(word) & ((1 << 63) - 1)


# ---------------------------------------------------------------------------
# Abstract layouts (the dry run): meta tensors, nothing allocated
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_sharded_tables(c_meta: dict, n_dev: int, k_loc: int,
                            n_pad: int) -> ShardedTables:
    """The world's localised tables as ``meta`` tensors (the reference's
    ``abstract_sharded_tables``, ``:101-112``)."""
    cols = n_dev * k_loc
    return ShardedTables(
        targets=_meta((n_pad + 1, cols), torch.int32),
        weights=_meta((n_pad + 1, cols), torch.float32),
        dbins=_meta((n_pad + 1, cols), torch.int32),
        k_ext=_meta((n_pad,), torch.float32),
        i_dc=_meta((n_pad,), torch.float32))


def abstract_state(n_pad: int, n_dev: int, d_ring: int) -> ShardedSimState:
    """The world's global sharded state as ``meta`` tensors (the
    reference's ``abstract_state``, ``:127-137``; ``generator`` holds each
    rank's generator state where the reference holds its key)."""
    return ShardedSimState(
        V=_meta((n_pad,), torch.float32),
        I_ex=_meta((n_pad,), torch.float32),
        I_in=_meta((n_pad,), torch.float32),
        refrac=_meta((n_pad,), torch.int32),
        ring=_meta((d_ring, 2, n_pad + n_dev), torch.float32),
        t=_meta((), torch.int32),
        generator=_meta((n_dev, GENERATOR_STATE_BYTES), torch.uint8),
        overflow=_meta((n_dev,), torch.int32))


# ---------------------------------------------------------------------------
# The dense strategy, sharded 2-D (the reference's :311-397)
# ---------------------------------------------------------------------------

class DenseSimState(NamedTuple):
    """The dense sharded step's state, replicated on every rank.  The
    reference keeps a PRNG key (``key``); a rank here draws from its
    ``generator`` (None when the step draws nothing)."""
    V: torch.Tensor         # [N]
    I_ex: torch.Tensor
    I_in: torch.Tensor
    refrac: torch.Tensor    # int32
    ring: torch.Tensor      # [D_ring, 2, N], updated in place
    t: torch.Tensor         # 0-d int32
    generator: Any          # torch.Generator | None (meta: its state)
    overflow: torch.Tensor  # 0-d int32


def dense_state(V: torch.Tensor, d_ring: int,
                generator: Optional[torch.Generator] = None
                ) -> DenseSimState:
    """A fresh dense state from ``V`` [N]: currents, refractory counters,
    ring and counters 0."""
    n, dev = V.shape[0], V.device
    z = lambda dtype: torch.zeros(n, dtype=dtype, device=dev)
    return DenseSimState(
        V=V.clone(), I_ex=z(torch.float32), I_in=z(torch.float32),
        refrac=z(torch.int32),
        ring=torch.zeros((d_ring, 2, n), dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        generator=generator,
        overflow=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_dense(n: int, d_ring: int, dtype=torch.bfloat16):
    """``(state, W, aux)`` of the dense step as ``meta`` tensors (the
    reference's ``abstract_dense``, ``:326-335``)."""
    state = DenseSimState(
        V=_meta((n,), torch.float32), I_ex=_meta((n,), torch.float32),
        I_in=_meta((n,), torch.float32), refrac=_meta((n,), torch.int32),
        ring=_meta((d_ring, 2, n), torch.float32),
        t=_meta((), torch.int32),
        generator=_meta((GENERATOR_STATE_BYTES,), torch.uint8),
        overflow=_meta((), torch.int32))
    W = _meta((d_ring, n, n), dtype)
    aux = {"k_ext": _meta((n,), torch.float32),
           "i_dc": _meta((n,), torch.float32)}
    return state, W, aux


def dense_shardings(mesh, state: DenseSimState, W, aux):
    """Placements (one per mesh dim) of ``(state, W, aux)``: ``W``'s dim 1
    (the sources) over every mesh dim but ``model``, its dim 2 (the
    targets) over ``model``; the ``[N]`` state and ``aux`` replicated (300
    KB at full scale).  The reference's ``P(None, pre, "model")``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import mesh_axes
    names = mesh_axes(mesh)[0]
    rep = tuple(Replicate() for _ in names)
    w_sh = tuple(Shard(2) if a == "model" else Shard(1) for a in names)
    st = DenseSimState(*(rep for _ in state))
    ax = {k: rep for k in aux}
    return st, w_sh, ax


def dense_block(W: torch.Tensor, world) -> torch.Tensor:
    """Rank ``world.coord``'s block ``W[:, pre_block, post_block]`` of the
    world's ``W[D, N, N]`` (a contiguous copy, but for a world of one)."""
    n_pre, n_model = world.shape
    if (n_pre, n_model) == (1, 1):
        return W
    p, q = W.shape[1] // n_pre, W.shape[2] // n_model
    i, j = world.coord
    return W[:, i * p:(i + 1) * p, j * q:(j + 1) * q].contiguous()


def make_dense_step(world2d, prop: Propagators, *, n: int, n_exc: int,
                    w_ext: float, bg_rate: float, dt: float, n_steps: int,
                    matvec: Optional[Callable] = None):
    """``sim_chunk(state, W_block, aux) -> (state, counts [n_steps])``: the
    reference's ``make_dense_step`` (``:347-397``) on one rank of
    ``world2d`` (``launch.mesh.World2d``; ``World2d()`` is a world of one).

    The state is replicated (every rank steps the same ``[N]`` state, and
    draws the same Poisson stream from its own generator when ``bg_rate``
    is positive); ``W_block`` is the rank's ``W[:, pre_block, post_block]``
    (:func:`dense_block`), float32 or bfloat16, and ``aux`` holds ``k_ext``
    and ``i_dc`` ``[N]``.  A step reads and consumes the ring's slot, adds
    the drive, integrates as the reference does, then delivers on one
    signed channel (the model's equal synaptic time constants): the local
    product ``matvec(spiked[pre_block], W_block)`` (K5's wrapper unless
    given: the kernel on the card, its plain version on the CPU; a bf16
    block is widened as it is read), all-reduced over the ``data`` group,
    all-gathered over ``model``, rolled by ``t`` and added into channel 0
    of the ring, in place.  ``n_exc`` is unused (one signed channel), as in
    the reference.
    """
    if not (prop.P11_ex == prop.P11_in and prop.P21_ex == prop.P21_in):
        raise ValueError("the dense sharded step delivers on one signed "
                         "channel: it needs equal synaptic time constants")
    n_pre, n_model = world2d.shape
    if n % n_pre or n % n_model:
        raise ValueError(f"N={n} does not split over a {n_pre} x {n_model} "
                         f"world")
    matvec = matvec or gated_spike_matvec
    lam_scale = bg_rate * dt * 1e-3
    p_blk = n // n_pre
    lo = world2d.coord[0] * p_blk

    def step(st: DenseSimState, W_blk: torch.Tensor,
             aux: Dict[str, torch.Tensor]):
        slot = slot_index(st.t, st.ring.shape[0])
        arrivals = st.ring.index_select(0, slot)[0]            # [2, N]
        in_ex, in_in = arrivals[0], arrivals[1]
        if lam_scale > 0:
            gen = st.generator if isinstance(st.generator,
                                             torch.Generator) else None
            ext = torch.poisson(aux["k_ext"] * lam_scale,
                                generator=gen).to(torch.int32)
            in_ex = in_ex + w_ext * ext.to(in_ex.dtype)
        V = (prop.E_L + (st.V - prop.E_L) * prop.P22
             + st.I_ex * prop.P21_ex + st.I_in * prop.P21_in
             + aux["i_dc"] * prop.P20)
        I_ex = st.I_ex * prop.P11_ex + in_ex
        I_in = st.I_in * prop.P11_in + in_in
        refr = st.refrac > 0
        V = torch.where(refr, prop.V_reset, V)
        spiked = (V >= prop.V_th) & ~refr
        V = torch.where(spiked, prop.V_reset, V)
        refrac = torch.where(spiked, prop.ref_steps,
                             torch.clamp(st.refrac - 1, min=0)
                             ).to(torch.int32)
        st.ring.index_fill_(0, slot, 0.0)
        part = matvec(spiked[lo:lo + p_blk], W_blk)            # [D, n/model]
        upd = world2d.all_gather_model(world2d.all_reduce_data(part))
        st.ring[:, 0, :] += rolled(upd, st.t)
        new = DenseSimState(V, I_ex, I_in, refrac, st.ring, st.t + 1,
                            st.generator, st.overflow)
        return new, spiked.sum(dtype=torch.int32)

    def sim_chunk(state: DenseSimState, W_blk: torch.Tensor,
                  aux: Dict[str, torch.Tensor]):
        counts = []
        for _ in range(n_steps):
            state, c = step(state, W_blk, aux)
            counts.append(c)
        return state, torch.stack(counts) if counts else torch.zeros(
            0, dtype=torch.int32, device=state.V.device)

    sim_chunk.step = step
    return sim_chunk
