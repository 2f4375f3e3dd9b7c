"""Plasticity rules: a protocol plus a registry.

The port's counterpart of ``repro.core.plasticity``.  A rule is a frozen
dataclass registered under a ``kind`` (``to_dict`` / ``from_dict`` for
JSON), *bound* once per session against the connectome and the delivery
strategy's device tables.  Built-in::

    pair_stdp(...)    trace-based pair STDP on the E->E synapses
                      (Morrison et al. 2008)

Layout, unlike the reference's on purpose: the canonical plastic weights
are the delivery strategy's own ``[N+1, K]`` weight table (``K = K_pad``
for ``ell``, ``K_out`` for ``event``), cloned from the connectome's table by
``init`` and updated in place by the kernels.  The transposed IN view
indexes that table (``in_syn_idx = row * K + col``), so the live tables of
a step are a re-wrap with no copy; the reference keeps a flat
``(N+1) * K_out + 1`` array and pads it to ``K_pad`` every step, a 2 GB
copy at full scale.  ``in_sources`` is not stored: it equals
``in_syn_idx // K`` on every entry (the fill ``N * K`` gives ``N``).

The bound object (:class:`BoundPlasticity`, what ``api.backends.
FusedBackend`` consumes) has ``tables``, ``plastic_mask`` (``[N+1, K]``
bool), ``init() -> state`` and ``step(state, spiked, ids, clip_all) ->
state`` (one whole update for a step's spike vector and the ids its
delivery compacted; ``clip_all`` marks a run's first step).  The
deprecated ``simulate_plastic`` is a shim over ``Simulator(plasticity=
...)``, as in the reference; ``Simulator(stdp=...)`` is not ported.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kernel_policy as kpol
from repro_torch.kernels import stdp as stdp_kernel
from repro_torch.kernels.stdp import StdpCoef

_W_REF_FULL = 87.8     # pA reference weight at full scale (0.15 mV PSP)


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    """Parameters of the pair-STDP update.  The one a bound rule runs has
    ``w_ref`` scaled by the connectome's external weight
    (``PairSTDP.scaled``); ``PairSTDP.from_stdp_config`` and
    ``simulate_plastic`` take one with the full-scale ``w_ref``, as the
    reference's do."""
    tau_plus: float = 20.0     # ms, pre-trace
    tau_minus: float = 20.0    # ms, post-trace
    A_plus: float = 0.01
    A_minus: float = 0.012     # slight depression bias (stability)
    lr: float = 1.0            # scales both amplitudes (units of w_ref)
    w_ref: float = _W_REF_FULL # pA reference weight (PSC of 0.15 mV PSP)
    w_max_factor: float = 3.0  # clip at w_max_factor * w_ref
    dt: float = 0.1


class PlasticTables(NamedTuple):
    """OUT and IN views of the plastic synapse population.  The OUT view's
    targets and delay bins are the delivery tables' own tensors."""
    out_targets: torch.Tensor   # [N+1, K] int32 (post ids; sentinel N)
    out_dbins: torch.Tensor     # [N+1, K] int32
    in_syn_idx: torch.Tensor    # [N+1, K_in] int32, row * K + col
    plastic_out: torch.Tensor   # [N+1, K] bool (E->E synapses)
    plastic_in: torch.Tensor    # [N+1, K_in] bool

    @property
    def in_sources(self) -> torch.Tensor:
        """``[N+1, K_in]`` pre ids (sentinel N), derived."""
        return torch.div(self.in_syn_idx, self.out_targets.shape[1],
                         rounding_mode="floor")


class PlasticState(NamedTuple):
    weights: torch.Tensor       # [N+1, K] f32, the live table (in place)
    x_pre: torch.Tensor         # [N] f32
    x_post: torch.Tensor        # [N] f32


def build_plastic_tables(tables, n_exc: int) -> PlasticTables:
    """The plastic views of the delivery ``tables`` (``[N+1, K]``, sentinel
    row N), built on the tables' device.

    The reference's IN view (``repro/core/plasticity.py:93``) groups the
    real synapses by target with a stable sort of their flat OUT index;
    here a stable ``torch.sort`` of the targets over the whole table does
    the same (padding and the sentinel row hold target N and sort last), so
    the rows are identical, re-indexed to ``K`` columns.
    """
    tgt = tables.targets
    n = tgt.shape[0] - 1
    k = tgt.shape[1]
    if (n + 1) * k >= 2 ** 31:
        raise ValueError("the plastic tables index the weight table with "
                         "int32; it has too many entries")
    dev = tgt.device
    rows = torch.arange(n + 1, device=dev)
    plastic_out = (rows < n_exc)[:, None] & (tgt < n_exc)
    flat_t = tgt.reshape(-1)
    in_deg = torch.bincount(flat_t, minlength=n + 1)[:n]
    n_syn = int(in_deg.sum())
    order = torch.sort(flat_t, stable=True).indices[:n_syn]
    t_sorted = flat_t[order].to(torch.int64)
    k_in = int(in_deg.max()) if n_syn else 1
    starts = torch.cumsum(in_deg, 0) - in_deg
    col = torch.arange(n_syn, device=dev) - starts[t_sorted]
    in_syn = torch.full((n + 1, k_in), n * k, dtype=torch.int32, device=dev)
    in_syn[t_sorted, col] = order.to(torch.int32)
    plastic_in = torch.zeros((n + 1, k_in), dtype=torch.bool, device=dev)
    plastic_in[t_sorted, col] = plastic_out.reshape(-1)[order]
    return PlasticTables(out_targets=tgt, out_dbins=tables.dbins,
                         in_syn_idx=in_syn, plastic_out=plastic_out,
                         plastic_in=plastic_in)


def stdp_coefficients(cfg: STDPConfig) -> StdpCoef:
    """The immediates ``stdp_step`` folds into its ops, as the reference's
    ``stdp_coefficients`` (:195) gives them, plus ``w_max``."""
    return StdpCoef(dep=float(cfg.lr * cfg.A_minus * cfg.w_ref),
                    pot=float(cfg.lr * cfg.A_plus * cfg.w_ref),
                    decay_p=float(np.exp(-cfg.dt / cfg.tau_plus)),
                    decay_m=float(np.exp(-cfg.dt / cfg.tau_minus)),
                    w_max=float(cfg.w_max_factor * cfg.w_ref))


def _update(kernel: bool):
    return stdp_kernel.stdp_update if kernel \
        else stdp_kernel.stdp_update_plain


def stdp_step(ps: PlasticState, tables: PlasticTables, spiked: torch.Tensor,
              ids: torch.Tensor, coef: StdpCoef, *, clip_all: bool = True,
              kernel: bool = True) -> PlasticState:
    """One plasticity step given this step's spike vector: depression,
    potentiation, the clip, the traces (``repro/core/plasticity.py:143``).
    ``ids`` are ``spiked``'s ids as the step's delivery compacted them
    (the lowest ``budget`` ascending, then the sentinel N), so the update
    touches the rows the reference's ``nonzero(size=budget)`` picks.
    ``ps.weights`` is updated in place.  ``clip_all=False`` clips only the
    entries this step touched, which equals the reference's whole-table
    clip once the table is clipped.  ``kernel`` picks ``stdp_update``
    (its plain version for CPU tensors), else the plain version."""
    w, x_pre, x_post = _update(kernel)(
        ps.weights, tables.out_targets, tables.plastic_out,
        tables.in_syn_idx, tables.plastic_in, ids, ps.x_pre, ps.x_post,
        spiked, coef, full=True, clip_all=clip_all)
    return PlasticState(w, x_pre, x_post)


def stdp_pot_clip(w: torch.Tensor, x_pre: torch.Tensor, ids: torch.Tensor,
                  tables: PlasticTables, coef: StdpCoef, *,
                  clip_all: bool = True, kernel: bool = True
                  ) -> torch.Tensor:
    """The potentiation and clip half of :func:`stdp_step`, on a table
    that carries the step's depression already (K4's), for the padded ids
    K4 delivered; ``x_pre`` is the trace before the step's bump
    (``repro/core/plasticity.py:206``).  ``w`` is updated in place."""
    return _update(kernel)(
        w, tables.out_targets, tables.plastic_out, tables.in_syn_idx,
        tables.plastic_in, ids, x_pre, None, None, coef, full=False,
        clip_all=clip_all)[0]


def plastic_weight_view(ps: PlasticState, n: int, k_out: int
                        ) -> torch.Tensor:
    """The ``[N+1, K_out]`` weight table: a view of the live table's first
    ``k_out`` columns (the reference slices its flat array,
    ``repro/core/plasticity.py:237``)."""
    return ps.weights[:n + 1, :k_out]


def mean_plastic_weight(weights: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Mean weight over the plastic entries (0-d float32 on the device)."""
    n_plastic = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, weights, 0.0).sum() / n_plastic


# ---------------------------------------------------------------------------
# The rule protocol and registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, type] = {}


def register(kind: str):
    """Class decorator: register a :class:`PlasticityRule` under ``kind``."""
    def deco(cls):
        if not (isinstance(cls, type) and issubclass(cls, PlasticityRule)):
            raise TypeError(f"@register({kind!r}) needs a PlasticityRule "
                            f"subclass, got {cls!r}")
        if kind in REGISTRY:
            raise ValueError(f"plasticity rule {kind!r} already registered")
        cls.kind = kind
        REGISTRY[kind] = cls
        return cls
    return deco


def available_rules() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


@dataclasses.dataclass(frozen=True)
class PlasticityRule:
    """One synaptic plasticity mechanism, as data; ``bind`` lowers it
    against a connectome, its resolved ``SimConfig`` and the delivery
    strategy's device tables (see the module docstring)."""

    kind = "abstract"     # set by @register

    def bind(self, c, cfg, tables):
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"kind": self.kind, **dataclasses.asdict(self)}

    @staticmethod
    def from_dict(d: dict) -> "PlasticityRule":
        d = dict(d)
        kind = d.pop("kind", None)
        if kind not in REGISTRY:
            raise ValueError(f"unknown plasticity rule kind {kind!r}; "
                             f"available: {available_rules()}")
        cls = REGISTRY[kind]
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown field(s) {sorted(unknown)} for "
                             f"plasticity rule {kind!r} "
                             f"(known: {sorted(known)})")
        return cls(**d)


class BoundPlasticity:
    """The shape of ``rule.bind(...)``'s result (duck-typed: a custom rule
    may return any object with these members)."""

    tables: Any = None
    plastic_mask: Optional[torch.Tensor] = None

    def init(self) -> Any:
        """A fresh plastic state."""
        raise NotImplementedError

    def step(self, state, spiked: torch.Tensor, ids: torch.Tensor,
             clip_all: bool = True):
        """One whole update for a step's spikes and the ids its delivery
        compacted."""
        raise NotImplementedError


def resolve_rule(spec) -> PlasticityRule:
    """Normalise a rule spec: a registry kind name, a spec dict (``{"kind":
    ..., **params}``), a :class:`PlasticityRule`, ``True`` (the default
    :class:`PairSTDP`) or an :class:`STDPConfig`."""
    if isinstance(spec, PlasticityRule):
        return spec
    if spec is True:
        return PairSTDP()
    if isinstance(spec, STDPConfig):
        return PairSTDP.from_stdp_config(spec)
    if isinstance(spec, str):
        if spec not in REGISTRY:
            raise ValueError(f"unknown plasticity rule {spec!r}; "
                             f"available: {available_rules()}")
        return REGISTRY[spec]()
    if isinstance(spec, dict):
        return PlasticityRule.from_dict(spec)
    raise TypeError(f"plasticity must be a rule kind name, spec dict, "
                    f"PlasticityRule, True or STDPConfig; got {type(spec)}")


# ---------------------------------------------------------------------------
# Registered implementations
# ---------------------------------------------------------------------------

class _BoundPairSTDP(BoundPlasticity):
    """Pair STDP lowered against a connectome (scaled config + tables)."""

    def __init__(self, cfg: STDPConfig, tables: PlasticTables,
                 weights0: torch.Tensor, kernel: bool):
        self.cfg = cfg
        self.coef = stdp_coefficients(cfg)
        self.tables = tables
        self.plastic_mask = tables.plastic_out
        self.kernel = kernel
        self._weights0 = weights0

    def init(self) -> PlasticState:
        """Fresh plastic state: the connectome's weights, zero traces."""
        n = self._weights0.shape[0] - 1
        zeros = lambda: torch.zeros(n, dtype=torch.float32,
                                    device=self._weights0.device)
        return PlasticState(self._weights0.clone(), zeros(), zeros())

    def step(self, state: PlasticState, spiked: torch.Tensor,
             ids: torch.Tensor, clip_all: bool = True) -> PlasticState:
        return stdp_step(state, self.tables, spiked, ids, self.coef,
                         clip_all=clip_all, kernel=self.kernel)


@register("pair_stdp")
@dataclasses.dataclass(frozen=True)
class PairSTDP(PlasticityRule):
    """Classic trace-based pair STDP on the E->E synapses::

        x_pre  += 1 on pre spike,  decays with tau_plus
        x_post += 1 on post spike, decays with tau_minus
        on pre spike  at (i->j):  w -= lr * A_minus * x_post[j]  (depress)
        on post spike at (i->j):  w += lr * A_plus  * x_pre[i]   (potentiate)

    ``w_ref`` is the full-scale reference weight; binding scales it by the
    connectome's external weight (down-scaled nets carry boosted weights),
    so ``w_max`` and the amplitudes track the scale.  ``dt=None`` takes the
    step from the session's ``SimConfig``.
    """
    tau_plus: float = 20.0
    tau_minus: float = 20.0
    A_plus: float = 0.01
    A_minus: float = 0.012
    lr: float = 1.0
    w_ref: float = _W_REF_FULL
    w_max_factor: float = 3.0
    dt: Optional[float] = None

    @classmethod
    def from_stdp_config(cls, cfg: STDPConfig) -> "PairSTDP":
        return cls(tau_plus=cfg.tau_plus, tau_minus=cfg.tau_minus,
                   A_plus=cfg.A_plus, A_minus=cfg.A_minus, lr=cfg.lr,
                   w_ref=cfg.w_ref, w_max_factor=cfg.w_max_factor,
                   dt=cfg.dt)

    def scaled(self, c, dt: float) -> STDPConfig:
        """The config ``bind`` runs: ``w_ref`` scaled by ``c.w_ext``."""
        return STDPConfig(
            tau_plus=self.tau_plus, tau_minus=self.tau_minus,
            A_plus=self.A_plus, A_minus=self.A_minus, lr=self.lr,
            w_ref=self.w_ref * float(c.w_ext) / _W_REF_FULL,
            w_max_factor=self.w_max_factor,
            dt=dt if self.dt is None else self.dt)

    def bind(self, c, cfg, tables) -> _BoundPairSTDP:
        pol = kpol.policy_of(cfg)
        if pol is None:
            raise ValueError(
                "SimConfig.kernels is unresolved; call repro_torch.core."
                "engine.resolve_sim_config first -- the backend does this "
                "in build()")
        return _BoundPairSTDP(self.scaled(c, cfg.dt),
                              build_plastic_tables(tables, c.n_exc),
                              tables.weights, pol.kernels)


# ---------------------------------------------------------------------------
# Deprecated front end
# ---------------------------------------------------------------------------

def simulate_plastic(c, t_sim_ms: float, sim_cfg, stdp_cfg: STDPConfig,
                     key: Optional[int] = None, device=None):
    """The microcircuit with live E->E STDP: ``(final_sim_state,
    final_plastic_state, (pop_counts [T, n_pops], mean plastic weight
    [T]))``, the recordings as numpy.

    .. deprecated:: a shim over ``repro_torch.api.Simulator(plasticity=
       ...)`` (``repro/core/plasticity.py:424-449``), which adds chunked
       runs, checkpoints and stream probes on the same trajectory.  ``key``
       is the session's int seed; ``device`` is the card unless the caller
       asks for the CPU.
    """
    warnings.warn(
        "simulate_plastic is deprecated; use repro_torch.api.Simulator("
        "plasticity='pair_stdp') -- the session API composes the same "
        "rule with run_chunked, checkpointing and stream probes",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api.simulator import Simulator
    sim = Simulator(connectome=c, sim_config=sim_cfg,
                    plasticity=PairSTDP.from_stdp_config(stdp_cfg),
                    probes=("pop_counts", "mean_plastic_weight"), key=key,
                    device=device)
    res = sim.run(t_sim_ms)
    sim_f, ps_f = sim.state
    return sim_f, ps_f, (res.data["pop_counts"],
                         res.data["mean_plastic_weight"])
