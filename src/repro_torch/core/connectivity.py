"""Connectivity construction for the microcircuit (host-side numpy).

A copy of ``repro.core.connectivity.build_connectome``: NEST's
``fixed_total_number`` rule per projection, K[t, s] synapses drawn with
independently uniform source and target neurons (multapses and autapses
allowed), laid out as a padded per-source ELL adjacency: for every source
neuron a fixed-width row of (target id, weight, delay bin), padded with the
sentinel target ``N`` (the ring buffer's trailing dump column).

The draw order from ``np.random.default_rng(seed)`` is the reference's, so
the same seed gives bit-identical tables in both packages.

The dense strategy's delay-binned table ``W[D, N_pre, N_post]`` has two
builders: ``dense_delay_binned`` is the reference's numpy ``np.add.at``
copy, ``dense_table`` builds the same table (or its source-major layout)
with PyTorch on the session's device, so that the card never waits on a
44 GB host array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import params as P


@dataclasses.dataclass
class Connectome:
    """Host-side connectome in ELL layout plus metadata."""
    n_total: int
    n_exc: int                      # neurons [0, n_exc) are excitatory
    pop_sizes: np.ndarray           # [8]
    pop_offsets: np.ndarray         # [9] prefix sum
    # ELL out-adjacency
    targets: np.ndarray             # [N, K_max] int32, sentinel == n_total
    weights: np.ndarray             # [N, K_max] float32 (signed, pA)
    dbins: np.ndarray               # [N, K_max] int32, ring slot offset >= 1
    out_degree: np.ndarray          # [N] int32
    n_synapses: int
    d_max_bins: int                 # ring buffer length D (>= max dbin + 1)
    # Per-neuron external drive
    k_ext: np.ndarray               # [N] float32 external in-degree
    i_dc: np.ndarray                # [N] float32 DC compensation (pA)
    w_ext: float                    # external synaptic weight (pA)
    v0_mean: np.ndarray             # [N]
    v0_sd: np.ndarray               # [N]
    pop_of: np.ndarray              # [N] int32 population index
    k_scaling: float = 1.0          # in-degree scaling this net was built at


def _truncated_normal(rng: np.random.Generator, mean, sd, low, high, size):
    """Draw normal(mean, sd) clipped into [low, high] (the reference clips
    where NEST redraws; the clip region is >= 4 sd from the mean)."""
    x = rng.normal(mean, sd, size=size)
    return np.clip(x, low, high)


def build_connectome(
    n_scaling: float = 1.0,
    k_scaling: float = 1.0,
    seed: int = 55,
    neuron: Optional[P.NeuronParams] = None,
    syn: Optional[P.SynapseParams] = None,
    inp: Optional[P.InputParams] = None,
    dt: float = 0.1,
    k_pad_to: Optional[int] = None,
    scale: Optional[float] = None,
) -> Connectome:
    """Instantiate the microcircuit at any scale.

    ``scale`` sets ``n_scaling`` and ``k_scaling`` at once, with the lost
    mean input compensated by a per-population DC current (van Albada et
    al. 2015); passing it together with explicit scalings raises.
    """
    if scale is not None:
        if (n_scaling, k_scaling) != (1.0, 1.0):
            raise ValueError(
                "pass either scale= or n_scaling=/k_scaling=, not both "
                f"(got scale={scale}, n_scaling={n_scaling}, "
                f"k_scaling={k_scaling})")
        if not 0.0 < scale <= 1.0:
            raise ValueError(f"scale must be in (0, 1], got {scale}")
        n_scaling = k_scaling = float(scale)
    neuron = neuron or P.NeuronParams()
    syn = syn or P.SynapseParams()
    inp = inp or P.InputParams()
    rng = np.random.default_rng(seed)

    n_full = np.array([P.N_FULL[p] for p in P.POPULATIONS], dtype=np.int64)
    n_pop = P.scaled_counts(n_scaling)
    offsets = np.concatenate([[0], np.cumsum(n_pop)])
    n_total = int(offsets[-1])
    n_exc = int(offsets[P.N_EXC_POPS])

    k_per_proj = P.synapse_numbers(n_full, P.CONN_PROBS, n_pop, k_scaling)

    w_e = P.psc_from_psp(syn.PSP_e, neuron)          # ~87.8 pA
    w_i = syn.g * w_e
    w_sd_rel = syn.PSP_rel_sd

    dt_bins = dt
    d_mean = np.array([syn.delay_e, syn.delay_i])
    d_sd = d_mean * syn.delay_rel_sd
    d_hi = d_mean + syn.d_clip_sigmas * d_sd
    d_max_bins = int(np.ceil(d_hi.max() / dt_bins)) + 1

    # --- sample every projection (the reference's draw order) ---------------
    srcs, tgts, ws, dbs = [], [], [], []
    for t_pop in range(8):
        for s_pop in range(8):
            k = int(k_per_proj[t_pop, s_pop])
            if k == 0:
                continue
            s = rng.integers(offsets[s_pop], offsets[s_pop + 1], size=k)
            t = rng.integers(offsets[t_pop], offsets[t_pop + 1], size=k)
            exc_src = s_pop < P.N_EXC_POPS
            w_mean = w_e if exc_src else w_i
            # L4E -> L23E doubled weight (PD 2014)
            if P.POPULATIONS[s_pop] == "L4E" and P.POPULATIONS[t_pop] == "L23E":
                w_mean = w_mean * syn.PSP_23e_4e_factor
            w_sd = abs(w_mean) * w_sd_rel
            if exc_src:
                w = _truncated_normal(rng, w_mean, w_sd, 0.0, np.inf, k)
            else:
                w = _truncated_normal(rng, w_mean, w_sd, -np.inf, 0.0, k)
            dm, ds, dh = ((d_mean[0], d_sd[0], d_hi[0]) if exc_src
                          else (d_mean[1], d_sd[1], d_hi[1]))
            d = _truncated_normal(rng, dm, ds, dt_bins, dh, k)
            db = np.maximum(1, np.round(d / dt_bins)).astype(np.int32)
            srcs.append(s); tgts.append(t); ws.append(w); dbs.append(db)

    src = np.concatenate(srcs).astype(np.int64)
    tgt = np.concatenate(tgts).astype(np.int32)
    w = np.concatenate(ws).astype(np.float32)
    db = np.concatenate(dbs).astype(np.int32)
    del srcs, tgts, ws, dbs
    n_syn = src.shape[0]

    # --- ELL layout: group synapses by source -------------------------------
    order = np.argsort(src, kind="stable")
    src, tgt, w, db = src[order], tgt[order], w[order], db[order]
    del order
    out_deg = np.bincount(src, minlength=n_total).astype(np.int32)
    k_max = int(out_deg.max()) if n_syn else 1
    if k_pad_to is not None:
        if k_pad_to < k_max:
            raise ValueError(f"k_pad_to={k_pad_to} < max out-degree {k_max}")
        k_max = k_pad_to
    row_start = np.concatenate([[0], np.cumsum(out_deg)]).astype(np.int64)
    col = np.arange(n_syn, dtype=np.int64) - row_start[src]

    targets = np.full((n_total, k_max), n_total, dtype=np.int32)
    weights = np.zeros((n_total, k_max), dtype=np.float32)
    dbins = np.ones((n_total, k_max), dtype=np.int32)
    targets[src, col] = tgt
    weights[src, col] = w
    dbins[src, col] = db
    del src, col, tgt, w, db

    # --- external drive + down-scaling DC compensation ----------------------
    pop_of = np.repeat(np.arange(8, dtype=np.int32), n_pop)
    k_ext_full = P.K_EXT.astype(np.float64)
    k_ext = k_ext_full * k_scaling

    w_scale = 1.0 / np.sqrt(k_scaling)
    weights *= np.float32(w_scale)
    w_ext = w_e * w_scale

    # van Albada et al. (2015): compensate the lost mean input with DC.
    indeg_full = (P.synapse_numbers(n_full, P.CONN_PROBS, n_full, 1.0)
                  / n_full[:, None])
    w_mat = np.where(np.arange(8)[None, :] < P.N_EXC_POPS, w_e, w_i)
    w_mat = np.broadcast_to(w_mat, (8, 8)).copy()
    s_l4e = P.POPULATIONS.index("L4E"); t_l23e = P.POPULATIONS.index("L23E")
    w_mat[t_l23e, s_l4e] *= syn.PSP_23e_4e_factor
    x1_rec = (indeg_full * w_mat * P.FULL_MEAN_RATES[None, :]).sum(axis=1)
    x1_ext = k_ext_full * w_e * inp.bg_rate
    tau_syn = neuron.tau_syn_ex
    i_dc_pop = 0.001 * tau_syn * (1.0 - np.sqrt(k_scaling)) * (x1_rec + x1_ext)

    return Connectome(
        n_total=n_total,
        n_exc=n_exc,
        pop_sizes=n_pop,
        pop_offsets=offsets,
        targets=targets,
        weights=weights,
        dbins=dbins,
        out_degree=out_deg,
        n_synapses=n_syn,
        d_max_bins=d_max_bins,
        k_ext=k_ext[pop_of].astype(np.float32),
        i_dc=i_dc_pop[pop_of].astype(np.float32),
        w_ext=float(w_ext),
        v0_mean=P.V0_MEAN[pop_of].astype(np.float32),
        v0_sd=P.V0_SD[pop_of].astype(np.float32),
        pop_of=pop_of,
        k_scaling=float(k_scaling),
    )


def dense_bytes_estimate(c: Connectome, itemsize: int = 4) -> int:
    """Footprint of the dense ``W[D, N, N]`` before allocating it."""
    return int(c.d_max_bins) * int(c.n_total) ** 2 * itemsize


#: Allocation cap for the dense strategy, read at call time so that it can
#: be raised here (``repro_torch.core.connectivity.DENSE_MAX_BYTES = ...``).
#: At full scale the dense table is about 1.1 TB; the guard turns the
#: inevitable out-of-memory error into an actionable one before anything
#: is allocated.
DENSE_MAX_BYTES = 8 * 1024 ** 3


def check_dense_bytes(c: Connectome, itemsize: int = 4,
                      max_bytes: Optional[float] = None) -> None:
    """Raise, naming the sparse strategies, when ``W[D, N, N]`` would
    exceed ``max_bytes`` (default: ``DENSE_MAX_BYTES``)."""
    if max_bytes is None:
        max_bytes = DENSE_MAX_BYTES
    D, n = c.d_max_bins, c.n_total
    est = dense_bytes_estimate(c, itemsize)
    if est > max_bytes:
        raise ValueError(
            f"dense delay-binned tensor W[{D}, {n}, {n}] needs "
            f"{est / 1e9:.1f} GB (> cap {max_bytes / 1e9:.1f} GB). The "
            f"dense strategy is O(N^2) per delay bin and cannot reach this "
            f"network size -- use strategy='ell' (O(N*K) sparse-ELL kernel "
            f"delivery) or strategy='event', or shrink the network via "
            f"build_connectome(scale=...). To force the allocation anyway "
            f"pass max_bytes=... or raise "
            f"repro_torch.core.connectivity.DENSE_MAX_BYTES.")


def dense_delay_binned(c: Connectome, dtype=np.float32,
                       max_bytes: Optional[float] = None) -> np.ndarray:
    """``W[D, N_pre, N_post]`` on the host, the reference's numpy build.

    Multapses within one (delay bin, pre, post) cell sum in the ELL
    table's order -- what ring-buffer accumulation of the single events
    gives up to rounding.  Guarded by ``check_dense_bytes``.
    """
    check_dense_bytes(c, np.dtype(dtype).itemsize, max_bytes)
    D, n = c.d_max_bins, c.n_total
    W = np.zeros((D, n, n), dtype=dtype)
    rows = np.repeat(np.arange(n), c.targets.shape[1])
    cols = c.targets.reshape(-1)
    ws = c.weights.reshape(-1)
    ds = c.dbins.reshape(-1)
    valid = cols < n
    np.add.at(W, (ds[valid], rows[valid], cols[valid]), ws[valid])
    return W


def dense_table(c: Connectome, device, source_major: bool = False,
                max_bytes: Optional[float] = None) -> torch.Tensor:
    """The dense table, float32, built with PyTorch on ``device``.

    Bin-major ``W[D, N, N]``, bitwise ``dense_delay_binned``'s; or, with
    ``source_major``, the same cells as ``[N, D * N]`` (``W.transpose(1,
    0, 2)``, flattened), built in place rather than transposed, so that
    either layout costs one table.  Guarded by ``check_dense_bytes``
    before anything is allocated.

    ``np.add.at`` adds a cell's multapses in the order of their ELL
    columns, and all of them lie in one row (the cell names its source).
    So the build walks the columns: pass ``j`` adds column ``j`` of every
    row that has one, one entry per row and hence no two into one cell,
    and the passes' order is the column order.  Linear offsets are int64:
    ``D * N * N`` passes 2**31 from scale 0.1 on.
    """
    check_dense_bytes(c, 4, max_bytes)
    D, n = c.d_max_bins, c.n_total
    W = torch.zeros(D * n * n, dtype=torch.float32, device=device)
    # rows by out-degree, descending: pass j covers a prefix of them
    order = np.argsort(-c.out_degree, kind="stable")
    n_rows = np.searchsorted(-c.out_degree[order],
                             -np.arange(c.targets.shape[1]), side="left")
    k_used = int(c.out_degree.max()) if n else 0
    on = lambda a: torch.from_numpy(
        np.ascontiguousarray(a[order, :k_used].T)).to(device)
    tg, ws, ds = on(c.targets), on(c.weights), on(c.dbins)
    src = torch.from_numpy(order.astype(np.int64)).to(device)
    for j in range(k_used):
        m = int(n_rows[j])
        t, d, p = tg[j, :m].long(), ds[j, :m].long(), src[:m]
        lin = ((p * D + d) * n + t) if source_major else ((d * n + p) * n + t)
        W.index_add_(0, lin, ws[j, :m])
    return W.view(n, D * n) if source_major else W.view(D, n, n)
