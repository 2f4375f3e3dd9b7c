"""The Potjans-Diesmann (2014) microcircuit's derived quantities, in numpy.

Read from ``pd14_tables.json`` beside this file, a frozen copy of the
paper's tables (populations, sizes, connection probabilities, external
in-degrees, rates, initial potentials, neuron and synapse parameters).
The connectome generator (``perfbench/netgen.py``) and the plain reference
(``perfbench/reference/lif_net.py``) both take the model from here, and
neither from the program under test.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

TABLES = json.loads((Path(__file__).with_name("pd14_tables.json"))
                    .read_text())
POPULATIONS = tuple(TABLES["populations"])
N_EXC_POPS = int(TABLES["n_exc_pops"])
N_FULL = np.array(TABLES["n_full"], dtype=np.int64)
CONN_PROBS = np.array(TABLES["conn_probs"], dtype=np.float64)   # [t, s]
K_EXT = np.array(TABLES["k_ext"], dtype=np.int64)
FULL_MEAN_RATES = np.array(TABLES["full_mean_rates_hz"], dtype=np.float64)
V0_MEAN = np.array(TABLES["v0_mean_mv"], dtype=np.float64)
V0_SD = np.array(TABLES["v0_sd_mv"], dtype=np.float64)
NEURON = dict(TABLES["neuron"])
SYNAPSE = dict(TABLES["synapse"])
BG_RATE_HZ = float(TABLES["bg_rate_hz"])


def scaled_counts(n_scaling: float) -> np.ndarray:
    """Neurons per population at ``n_scaling`` (at least one each)."""
    return np.maximum(1, np.round(N_FULL * n_scaling)).astype(np.int64)


def synapse_numbers(n_scaled: np.ndarray, k_scaling: float) -> np.ndarray:
    """Synapses per projection ``[t, s]`` (NEST's ``fixed_total_number``
    with multapses): ``K = ln(1 - p) / ln(1 - 1 / (N_t N_s))`` at full
    size, kept per target neuron and scaled by ``k_scaling``."""
    prod = np.outer(N_FULL.astype(np.float64), N_FULL.astype(np.float64))
    with np.errstate(divide="ignore"):
        k_full = np.where(CONN_PROBS > 0,
                          np.log1p(-CONN_PROBS) / np.log1p(-1.0 / prod), 0.0)
    indegree = k_full / N_FULL[:, None]
    return np.round(indegree * k_scaling * n_scaled[:, None]).astype(np.int64)


def psc_from_psp(psp: float) -> float:
    """Peak PSC (pA) of an exponential synapse that gives a ``psp`` mV
    peak PSP on the model neuron."""
    c_m, tau_m, tau_s = NEURON["C_m"], NEURON["tau_m"], NEURON["tau_syn_ex"]
    psc_over_psp = (c_m ** -1 * tau_m * tau_s / (tau_s - tau_m) * (
        (tau_m / tau_s) ** (-tau_m / (tau_m - tau_s))
        - (tau_m / tau_s) ** (-tau_s / (tau_m - tau_s)))) ** -1
    return psc_over_psp * psp


def w_exc() -> float:
    """The excitatory weight at full in-degree (about 87.8 pA)."""
    return psc_from_psp(SYNAPSE["PSP_e"])


def d_max_bins(dt: float) -> int:
    """Ring length D: the longest clipped delay in bins, plus one."""
    hi = max(SYNAPSE["delay_e"], SYNAPSE["delay_i"]) * (
        1.0 + SYNAPSE["d_clip_sigmas"] * SYNAPSE["delay_rel_sd"])
    return int(math.ceil(hi / dt)) + 1


def dc_compensation(k_scaling: float) -> np.ndarray:
    """Per-population DC (pA) that replaces the mean input lost by cutting
    the in-degrees (van Albada et al. 2015); 0 at full in-degree."""
    w_e = w_exc()
    w_i = SYNAPSE["g"] * w_e
    indeg = synapse_numbers(N_FULL, 1.0) / N_FULL[:, None]
    w_mat = np.where(np.arange(8)[None, :] < N_EXC_POPS, w_e, w_i)
    w_mat = np.broadcast_to(w_mat, (8, 8)).copy()
    w_mat[POPULATIONS.index("L23E"), POPULATIONS.index("L4E")] *= \
        SYNAPSE["PSP_23e_4e_factor"]
    x_rec = (indeg * w_mat * FULL_MEAN_RATES[None, :]).sum(axis=1)
    x_ext = K_EXT.astype(np.float64) * w_e * BG_RATE_HZ
    return (0.001 * NEURON["tau_syn_ex"] * (1.0 - math.sqrt(k_scaling))
            * (x_rec + x_ext))


def propagators(dt: float) -> dict:
    """Exact-integration propagators of ``iaf_psc_exp`` (Rotter &
    Diesmann 1999) for a step of ``dt`` ms, as Python floats."""
    n = NEURON
    exp = lambda x: float(np.exp(x))
    p22 = exp(-dt / n["tau_m"])

    def p21(tau_x):
        return ((exp(-dt / tau_x) - exp(-dt / n["tau_m"]))
                / (n["C_m"] * (1.0 / n["tau_m"] - 1.0 / tau_x)))
    return {"P11_ex": exp(-dt / n["tau_syn_ex"]),
            "P11_in": exp(-dt / n["tau_syn_in"]),
            "P22": p22, "P21_ex": p21(n["tau_syn_ex"]),
            "P21_in": p21(n["tau_syn_in"]),
            "P20": n["tau_m"] / n["C_m"] * (1.0 - p22),
            "ref_steps": int(round(n["t_ref"] / dt)),
            "V_th": n["V_th"], "V_reset": n["V_reset"], "E_L": n["E_L"]}
