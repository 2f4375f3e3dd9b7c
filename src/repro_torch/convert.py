"""Carry a simulation between the JAX package and the port.

The JAX package's tables and ``SimState``, given as numpy arrays, become the
port's ``Network`` and ``SimState`` on a device, and back, so both packages
can compute from the same start.  This module takes and gives plain numpy:
it imports nothing of JAX (the caller does ``np.asarray`` on its side).

Keys: ``targets``, ``weights``, ``dbins`` (the ``[N+1, K]`` event tables,
sentinel row included), ``k_ext``, ``i_dc``, ``pop_of``, ``V``, ``I_ex``,
``I_in``, ``refrac``, ``ring`` (``[D, 2, N+1]``), ``t`` and ``overflow``.
The JAX PRNG key has no counterpart: the port's state gets ``generator``.
``t`` is the 0-d int32 step counter both ways (a tensor on the device in
the port, as the reference's is a traced scalar).

The sharded side (``sharded_to_torch`` / ``sharded_to_numpy``) carries the
JAX package's global ``ShardedTables`` and ``ShardedSimState`` under
``SHARDED_KEYS`` (tables ``[N_pad+1, n_dev * k_loc]``, ``k_ext``, ``i_dc``
and the neuron state ``[N_pad]``, the ring ``[D, 2, N_pad + n_dev]``: each
rank's ``n_loc + 1`` columns end to end, ``overflow`` one per rank) into
one rank's shard of the port's, and the shards of all ranks back;
``sharded_state_to_torch`` takes the state alone (a sharded session's
checkpoint holds this layout).

The LM layers' weights (``layer_params_to_torch`` /
``layer_params_to_numpy``) are a nested dict of arrays, the value tree
that ``repro.models.layers.split_tree`` gives (as numpy), carried into
the port's dicts of tensors and back with the same keys.

The plastic side (``plastic_to_torch`` / ``plastic_to_numpy``) carries the
JAX package's ``PlasticState`` and ``PlasticTables`` under ``PLASTIC_KEYS``
(``weights`` flat, ``(N+1) * K_out + 1`` long: the ``[N+1, K_out]`` table
and one trailing dump slot, which nothing ever writes) into the port's
layout, where the weights are the ``[N+1, K]`` table of the delivery
strategy, ``K >= K_out`` columns zero-padded, and ``in_syn_idx`` indexes it
with stride ``K``; and back.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.delivery import EventTables
from repro_torch.core.distributed import ShardedSimState, ShardedTables
from repro_torch.core.engine import Network, SimState
from repro_torch.core.neuron import NeuronState
from repro_torch.core.plasticity import PlasticState, PlasticTables

KEYS = ("targets", "weights", "dbins", "k_ext", "i_dc", "pop_of", "V",
        "I_ex", "I_in", "refrac", "ring", "t", "overflow")


def to_torch(arrays: Dict[str, np.ndarray], device,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[Network, SimState]:
    """numpy arrays -> the port's ``(Network, SimState)`` on ``device``;
    every tensor is a copy."""
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing arrays {missing}")

    def t(name, dtype):
        a = np.array(arrays[name], dtype=dtype, copy=True)
        return torch.from_numpy(a).to(device)

    net = Network(
        tables=EventTables(targets=t("targets", np.int32),
                           weights=t("weights", np.float32),
                           dbins=t("dbins", np.int32)),
        k_ext=t("k_ext", np.float32), i_dc=t("i_dc", np.float32),
        pop_of=t("pop_of", np.int32))
    neuron = NeuronState(V=t("V", np.float32), I_ex=t("I_ex", np.float32),
                         I_in=t("I_in", np.float32),
                         refrac=t("refrac", np.int32))
    state = SimState(neuron=neuron, ring=t("ring", np.float32),
                     t=t("t", np.int32).reshape(()), generator=generator,
                     overflow=t("overflow", np.int32).reshape(()))
    return net, state


def to_numpy(net: Network, state: SimState) -> Dict[str, np.ndarray]:
    """The port's ``(Network, SimState)`` -> numpy arrays under ``KEYS``."""
    host = lambda x: x.detach().cpu().numpy()
    return {
        "targets": host(net.tables.targets),
        "weights": host(net.tables.weights),
        "dbins": host(net.tables.dbins),
        "k_ext": host(net.k_ext), "i_dc": host(net.i_dc),
        "pop_of": host(net.pop_of),
        "V": host(state.neuron.V), "I_ex": host(state.neuron.I_ex),
        "I_in": host(state.neuron.I_in),
        "refrac": host(state.neuron.refrac),
        "ring": host(state.ring),
        "t": host(state.t).astype(np.int32).reshape(()),
        "overflow": host(state.overflow),
    }


SHARDED_KEYS = ("targets", "weights", "dbins", "k_ext", "i_dc", "V",
                "I_ex", "I_in", "refrac", "ring", "t", "overflow")


def sharded_to_torch(arrays: Dict[str, np.ndarray], rank: int, n_dev: int,
                     device, generator: Optional[torch.Generator] = None
                     ) -> Tuple[ShardedTables, ShardedSimState]:
    """The reference's global sharded arrays (``SHARDED_KEYS``) -> rank
    ``rank``'s ``(ShardedTables, ShardedSimState)`` of a world of
    ``n_dev``, on ``device``; every tensor is a copy."""
    missing = [k for k in SHARDED_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"missing arrays {missing}")
    state = sharded_state_to_torch(arrays, rank, n_dev, device, generator)
    cols = np.asarray(arrays["targets"]).shape[1]
    if cols % n_dev:
        raise ValueError(f"rank {rank} of {n_dev}: {cols} table columns do "
                         f"not split evenly")
    k_loc, n_loc = cols // n_dev, state.V.shape[0]
    block = (slice(None), slice(rank * k_loc, (rank + 1) * k_loc))
    own = slice(rank * n_loc, (rank + 1) * n_loc)
    t = lambda name, dtype, part: _copy_to(arrays[name], dtype, part, device)
    tables = ShardedTables(
        targets=t("targets", np.int32, block),
        weights=t("weights", np.float32, block),
        dbins=t("dbins", np.int32, block), k_ext=t("k_ext", np.float32, own),
        i_dc=t("i_dc", np.float32, own))
    return tables, state


def _copy_to(a, dtype, part, device) -> torch.Tensor:
    a = np.asarray(a, dtype=dtype)
    a = a if part is None else a[part]
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def sharded_state_to_torch(arrays: Dict[str, np.ndarray], rank: int,
                           n_dev: int, device,
                           generator: Optional[torch.Generator] = None
                           ) -> ShardedSimState:
    """The state keys of the reference's global sharded layout (``V``,
    ``I_ex``, ``I_in``, ``refrac``, ``ring``, ``t``, ``overflow``) -> rank
    ``rank``'s ``ShardedSimState`` of a world of ``n_dev``, on ``device``
    (copies): its ``n_loc`` neurons, its ``n_loc + 1`` ring columns, and
    its overflow slot (the only one when one is given)."""
    n_pad = np.asarray(arrays["V"]).shape[0]
    n_loc = n_pad // n_dev
    if n_loc * n_dev != n_pad or not 0 <= rank < n_dev:
        raise ValueError(f"rank {rank} of {n_dev}: N_pad={n_pad} does not "
                         f"split evenly")
    own = slice(rank * n_loc, (rank + 1) * n_loc)
    ring = (slice(None), slice(None),
            slice(rank * (n_loc + 1), (rank + 1) * (n_loc + 1)))
    overflow = np.asarray(arrays["overflow"], np.int32).reshape(-1)
    t = lambda name, dtype, part=None: _copy_to(arrays[name], dtype, part,
                                                device)
    return ShardedSimState(
        V=t("V", np.float32, own), I_ex=t("I_ex", np.float32, own),
        I_in=t("I_in", np.float32, own), refrac=t("refrac", np.int32, own),
        ring=t("ring", np.float32, ring), t=t("t", np.int32).reshape(()),
        generator=generator,
        overflow=torch.tensor(int(overflow[rank if overflow.size > 1
                                           else 0]),
                              dtype=torch.int32, device=device))


def sharded_to_numpy(shards) -> Dict[str, np.ndarray]:
    """Every rank's ``(ShardedTables, ShardedSimState)``, rank 0 first,
    -> the reference's global layout under ``SHARDED_KEYS`` (a pair whose
    tables are None gives the state's keys only)."""
    host = lambda x: x.detach().cpu().numpy()
    tables = [tb for tb, _ in shards]
    states = [st for _, st in shards]
    cat = lambda xs, axis=0: np.concatenate([host(x) for x in xs], axis)
    out = {name: cat([getattr(st, name) for st in states])
           for name in ("V", "I_ex", "I_in", "refrac")}
    out["ring"] = cat([st.ring for st in states], 2)
    out["t"] = host(states[0].t).astype(np.int32).reshape(())
    out["overflow"] = np.stack([host(st.overflow).reshape(())
                                for st in states]).astype(np.int32)
    if all(tb is not None for tb in tables):
        for name in ("targets", "weights", "dbins"):
            out[name] = cat([getattr(tb, name) for tb in tables], 1)
        out["k_ext"] = cat([tb.k_ext for tb in tables])
        out["i_dc"] = cat([tb.i_dc for tb in tables])
    return out


PLASTIC_KEYS = ("weights", "x_pre", "x_post", "out_targets", "out_dbins",
                "in_syn_idx", "plastic_out", "plastic_in")


def _pad_cols(a: np.ndarray, k: int, fill) -> np.ndarray:
    out = np.full((a.shape[0], k), fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


def plastic_to_torch(arrays: Dict[str, np.ndarray], k: int, device
                     ) -> Tuple[PlasticTables, PlasticState]:
    """The JAX package's plastic arrays -> the port's ``(PlasticTables,
    PlasticState)`` for a delivery table of ``k`` columns; copies."""
    missing = [name for name in PLASTIC_KEYS if name not in arrays]
    if missing:
        raise KeyError(f"missing arrays {missing}")
    tgt = np.asarray(arrays["out_targets"], np.int32)
    rows, k_out = tgt.shape
    n = rows - 1
    w = np.asarray(arrays["weights"], np.float32)
    if w.shape != (rows * k_out + 1,) or k < k_out:
        raise ValueError(f"weights of {w.shape} do not fit a [{rows}, "
                         f"{k_out}] table padded to {k} columns")
    syn = np.asarray(arrays["in_syn_idx"], np.int64)
    on = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    tables = PlasticTables(
        out_targets=on(_pad_cols(tgt, k, n)),
        out_dbins=on(_pad_cols(np.asarray(arrays["out_dbins"], np.int32), k,
                               1)),
        in_syn_idx=on(((syn // k_out) * k + syn % k_out).astype(np.int32)),
        plastic_out=on(_pad_cols(np.asarray(arrays["plastic_out"], bool), k,
                                 False)),
        plastic_in=on(np.asarray(arrays["plastic_in"], bool)))
    state = PlasticState(
        weights=on(_pad_cols(w[:-1].reshape(rows, k_out), k, 0.0)),
        x_pre=on(np.asarray(arrays["x_pre"], np.float32)),
        x_post=on(np.asarray(arrays["x_post"], np.float32)))
    return tables, state


def plastic_to_numpy(tables: PlasticTables, state: PlasticState,
                     k_out: int) -> Dict[str, np.ndarray]:
    """The port's plastic tables and state -> the JAX package's layout
    (``PLASTIC_KEYS``) with ``k_out`` columns."""
    host = lambda x: x.detach().cpu().numpy()
    k = tables.out_targets.shape[1]
    syn = host(tables.in_syn_idx).astype(np.int64)
    w = host(state.weights)[:, :k_out]
    return {
        "weights": np.concatenate([w.reshape(-1), np.zeros(1, np.float32)]),
        "x_pre": host(state.x_pre), "x_post": host(state.x_post),
        "out_targets": host(tables.out_targets)[:, :k_out],
        "out_dbins": host(tables.out_dbins)[:, :k_out],
        "in_syn_idx": ((syn // k) * k_out + syn % k).astype(np.int32),
        "plastic_out": host(tables.plastic_out)[:, :k_out],
        "plastic_in": host(tables.plastic_in),
    }


def layer_params_to_torch(tree: Any, device,
                          dtype: Optional[torch.dtype] = None) -> Any:
    """A nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (copies), in ``dtype`` if given, else in each array's own
    type.  A bfloat16 array (``ml_dtypes``, as JAX hands them out) goes
    through float32, which holds it exactly."""
    if isinstance(tree, dict):
        return {k: layer_params_to_torch(v, device, dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(a, np.float32 if bf16 else a.dtype,
                                  copy=True))
    if bf16:
        t = t.to(torch.bfloat16)
    return t.to(device=device, dtype=dtype or t.dtype)


def layer_params_to_numpy(tree: Any) -> Any:
    """The port's dict of tensors -> the same dict of numpy arrays; a
    bfloat16 tensor becomes float32 (numpy has no bfloat16), exactly."""
    if isinstance(tree, dict):
        return {k: layer_params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
