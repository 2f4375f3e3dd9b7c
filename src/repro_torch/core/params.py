"""Potjans & Diesmann (2014) cortical microcircuit parameters.

Values follow the reference PyNEST implementation of the microcircuit model
(nest-simulator/pynest/examples/Potjans_2014) which is the model simulated by
Kurth et al. (2021), "Sub-realtime simulation of a neuronal network of natural
density".  All times are in ms, voltages in mV, currents in pA, capacitance in
pF, rates in Hz.

A numpy-only copy of ``repro.core.params`` (the port imports nothing of the
JAX package); the numbers must stay identical so both packages build the
same connectome from the same seed, and the ``thalamic_pulses`` stimulus
the same in-degrees.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Populations. Ordering is chosen so that all excitatory populations come
# first; this lets the dense delivery strategy split the weight matrix into an
# excitatory and an inhibitory row block without masking (Dale's law).
# ---------------------------------------------------------------------------
POPULATIONS: Tuple[str, ...] = (
    "L23E", "L4E", "L5E", "L6E",  # excitatory block
    "L23I", "L4I", "L5I", "L6I",  # inhibitory block
)
N_EXC_POPS = 4

# Full-scale neuron counts, Potjans & Diesmann (2014) Table 5.
N_FULL = {
    "L23E": 20683, "L23I": 5834,
    "L4E": 21915, "L4I": 5479,
    "L5E": 4850, "L5I": 1065,
    "L6E": 14395, "L6I": 2948,
}

# Connection probabilities (target row, source column) in the *canonical*
# paper ordering  [L23E, L23I, L4E, L4I, L5E, L5I, L6E, L6I].
_CONN_PROBS_CANONICAL = np.array([
    # from: L23E    L23I    L4E     L4I     L5E     L5I     L6E     L6I
    [0.1009, 0.1689, 0.0437, 0.0818, 0.0323, 0.0,    0.0076, 0.0],     # to L23E
    [0.1346, 0.1371, 0.0316, 0.0515, 0.0755, 0.0,    0.0042, 0.0],     # to L23I
    [0.0077, 0.0059, 0.0497, 0.1350, 0.0067, 0.0003, 0.0453, 0.0],     # to L4E
    [0.0691, 0.0029, 0.0794, 0.1597, 0.0033, 0.0,    0.1057, 0.0],     # to L4I
    [0.1004, 0.0622, 0.0505, 0.0057, 0.0831, 0.3726, 0.0204, 0.0],     # to L5E
    [0.0548, 0.0269, 0.0257, 0.0022, 0.0600, 0.3158, 0.0086, 0.0],     # to L5I
    [0.0156, 0.0066, 0.0211, 0.0166, 0.0572, 0.0197, 0.0396, 0.2252],  # to L6E
    [0.0364, 0.0010, 0.0034, 0.0005, 0.0277, 0.0080, 0.0658, 0.1443],  # to L6I
])
_CANONICAL_ORDER = ("L23E", "L23I", "L4E", "L4I", "L5E", "L5I", "L6E", "L6I")

def _reorder(mat: np.ndarray) -> np.ndarray:
    idx = [_CANONICAL_ORDER.index(p) for p in POPULATIONS]
    return mat[np.ix_(idx, idx)]

# conn_probs[t, s] = probability of a connection from population s to t,
# in the POPULATIONS (exc-first) ordering used throughout this package.
CONN_PROBS = _reorder(_CONN_PROBS_CANONICAL)

# External (Poisson) in-degrees per population, canonical order -> reordered.
_K_EXT_CANONICAL = {
    "L23E": 1600, "L23I": 1500, "L4E": 2100, "L4I": 1900,
    "L5E": 2000, "L5I": 1900, "L6E": 2900, "L6I": 2100,
}
K_EXT = np.array([_K_EXT_CANONICAL[p] for p in POPULATIONS], dtype=np.int64)

# Thalamic input (PD 2014 stimulation protocol): n_thal relay neurons
# project onto L4 and L6 with these connection probabilities (canonical
# order).  The ``thalamic_pulses`` stimulus (repro_torch.core.stimulus)
# drives the resulting in-degrees with pulsed Poisson trains at the external
# synaptic weight.
N_THAL = 902
_THAL_CONN_PROBS_CANONICAL = {
    "L23E": 0.0, "L23I": 0.0, "L4E": 0.0983, "L4I": 0.0619,
    "L5E": 0.0, "L5I": 0.0, "L6E": 0.0512, "L6I": 0.0196,
}
THAL_CONN_PROBS = np.array(
    [_THAL_CONN_PROBS_CANONICAL[p] for p in POPULATIONS], dtype=np.float64)


def thalamic_indegrees(k_scaling: float = 1.0) -> np.ndarray:
    """Per-population thalamic in-degree at ``k_scaling`` (fixed_total_number
    rule, multapses allowed -- the formula of :func:`synapse_numbers`)."""
    n_full = np.array([N_FULL[p] for p in POPULATIONS], dtype=np.float64)
    prod = n_full * float(N_THAL)
    with np.errstate(divide="ignore"):
        k_full = np.where(
            THAL_CONN_PROBS > 0,
            np.log1p(-THAL_CONN_PROBS) / np.log1p(-1.0 / prod),
            0.0,
        )
    return k_full / n_full * float(k_scaling)

# Stationary firing rates of the full-scale model (Hz), used for the
# down-scaling DC compensation (van Albada et al. 2015) and as the validation
# target band. Reference values from the official microcircuit implementation.
_FULL_MEAN_RATES_CANONICAL = {
    "L23E": 0.971, "L23I": 2.868, "L4E": 4.746, "L4I": 5.396,
    "L5E": 8.142, "L5I": 9.078, "L6E": 0.991, "L6I": 7.523,
}
FULL_MEAN_RATES = np.array(
    [_FULL_MEAN_RATES_CANONICAL[p] for p in POPULATIONS], dtype=np.float64)

# Optimized initial membrane-potential distribution (mean, sd per population)
# from Rhodes et al. (2019), as used by the paper ("optimized initial
# conditions"). Canonical order.
_V0_MEAN_CANONICAL = {
    "L23E": -68.28, "L23I": -63.16, "L4E": -63.33, "L4I": -63.45,
    "L5E": -63.11, "L5I": -61.66, "L6E": -66.72, "L6I": -61.43,
}
_V0_SD_CANONICAL = {
    "L23E": 5.36, "L23I": 4.57, "L4E": 4.74, "L4I": 4.94,
    "L5E": 4.94, "L5I": 4.55, "L6E": 5.46, "L6I": 4.48,
}
V0_MEAN = np.array([_V0_MEAN_CANONICAL[p] for p in POPULATIONS])
V0_SD = np.array([_V0_SD_CANONICAL[p] for p in POPULATIONS])


@dataclasses.dataclass(frozen=True)
class NeuronParams:
    """iaf_psc_exp parameters (NEST defaults for the microcircuit)."""
    C_m: float = 250.0        # pF
    tau_m: float = 10.0       # ms
    tau_syn_ex: float = 0.5   # ms
    tau_syn_in: float = 0.5   # ms
    E_L: float = -65.0        # mV
    V_th: float = -50.0       # mV
    V_reset: float = -65.0    # mV
    t_ref: float = 2.0        # ms


@dataclasses.dataclass(frozen=True)
class SynapseParams:
    PSP_e: float = 0.15        # mV, excitatory PSP amplitude
    PSP_rel_sd: float = 0.1    # relative sd of weights
    g: float = -4.0            # relative inhibitory synaptic strength
    PSP_23e_4e_factor: float = 2.0  # L4E -> L23E weight doubled
    delay_e: float = 1.5       # ms mean excitatory delay
    delay_i: float = 0.75      # ms mean inhibitory delay
    delay_rel_sd: float = 0.5  # relative sd of delays
    w_clip_sigmas: float = 10.0   # weights truncated at 0 (10 sd away)
    d_clip_sigmas: float = 4.0    # delays clipped to [dt, mean + 4 sd]


@dataclasses.dataclass(frozen=True)
class InputParams:
    """External-drive rate the DC compensation is computed for."""
    bg_rate: float = 8.0            # Hz per external synapse


@dataclasses.dataclass(frozen=True)
class SimParams:
    dt: float = 0.1            # ms resolution; also the min delay
    t_presim: float = 100.0    # ms discarded transient (paper: 0.1 s)
    t_sim: float = 1000.0      # ms of biological time


def psc_from_psp(psp: float, neuron: NeuronParams) -> float:
    """Peak PSC amplitude (pA) producing a PSP of `psp` mV (exp-PSC synapse).

    Mirrors `helpers.py` of the reference implementation: the maximum of the
    membrane-potential deflection for an exponential post-synaptic current.
    """
    C_m, tau_m, tau_s = neuron.C_m, neuron.tau_m, neuron.tau_syn_ex
    psc_over_psp = (C_m ** -1 * tau_m * tau_s / (tau_s - tau_m) * (
        (tau_m / tau_s) ** (-tau_m / (tau_m - tau_s))
        - (tau_m / tau_s) ** (-tau_s / (tau_m - tau_s)))) ** -1
    return psc_over_psp * psp


def synapse_numbers(n_full: np.ndarray, conn_probs: np.ndarray,
                    n_scaled: np.ndarray, k_scaling: float) -> np.ndarray:
    """Total synapse count per projection (fixed_total_number rule).

    K_full[t, s] = ln(1 - p[t, s]) / ln(1 - 1/(N_t * N_s)) as in the reference
    implementation (multapses/autapses allowed), then scaled to the reduced
    network: per-target in-degree is preserved up to `k_scaling`.
    """
    prod = np.outer(n_full.astype(np.float64), n_full.astype(np.float64))
    with np.errstate(divide="ignore"):
        k_full = np.where(
            conn_probs > 0,
            np.log1p(-conn_probs) / np.log1p(-1.0 / prod),
            0.0,
        )
    indegree_full = k_full / n_full[:, None]          # per target neuron
    k_scaled = indegree_full * k_scaling * n_scaled[:, None]
    return np.round(k_scaled).astype(np.int64)


def scaled_counts(n_scaling: float) -> np.ndarray:
    return np.maximum(
        1, np.round(np.array([N_FULL[p] for p in POPULATIONS]) * n_scaling)
    ).astype(np.int64)
