"""Carry a simulation between the JAX package and the port.

The JAX package's tables and ``SimState``, given as numpy arrays, become the
port's ``Network`` and ``SimState`` on a device, and back, so both packages
can compute from the same start.  This module takes and gives plain numpy:
it imports nothing of JAX (the caller does ``np.asarray`` on its side).

Keys: ``targets``, ``weights``, ``dbins`` (the ``[N+1, K]`` event tables,
sentinel row included), ``k_ext``, ``i_dc``, ``pop_of``, ``V``, ``I_ex``,
``I_in``, ``refrac``, ``ring`` (``[D, 2, N+1]``), ``t`` and ``overflow``.
The JAX PRNG key has no counterpart: the port's state gets ``generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.delivery import EventTables
from repro_torch.core.engine import Network, SimState
from repro_torch.core.neuron import NeuronState

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
                     t=int(arrays["t"]), generator=generator,
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
        "t": np.asarray(state.t, np.int32),
        "overflow": host(state.overflow),
    }
