"""Declarative experiments: scenario files run over the ``Simulator``.

The port's counterpart of ``repro.api.experiment``.  An
:class:`Experiment` is a model config, a stimulus timeline, a plasticity
rule, probes, a duration, a trial count and an optional validation gate,
as data.  ``to_dict`` / ``from_dict`` speak the JSON schema
``repro.experiment/v2`` (v1 documents, which have no ``plasticity``, are
read too), the reference's, so one scenario file
(``examples/scenarios/*.json``) runs verbatim in either package::

    from repro_torch.api import Experiment

    exp = Experiment.from_json("examples/scenarios/thalamic_pulses.json")
    result = exp.run()                      # on the card
    print(result.batch.rtf_mean, result.report and result.report.table())

``run()`` drives a :class:`~repro_torch.api.simulator.Simulator`
(``run_batch`` for ``trials > 1``: the trials one after the other over one
set of graphs) and returns an :class:`ExperimentResult`, with the
across-trial :class:`~repro_torch.validate.report.ValidationReport` when
``validate`` is set.

The module is also the scenario CLI::

    PYTHONPATH=src python -m repro_torch.api examples/scenarios/x.json
    PYTHONPATH=src python -m repro_torch.api x.json --device cpu

It runs on the card and raises without one, unless ``--device cpu`` asks
for the plain PyTorch versions on the CPU; exit code 4 is a failed
validation.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

from repro_torch.api.results import BatchResult, RunResult
from repro_torch.configs.microcircuit import MicrocircuitConfig
from repro_torch.core import plasticity as plasticity_mod
from repro_torch.core import stimulus as stimulus_mod

SCHEMA = "repro.experiment/v2"
# v1 documents (before plasticity) load unchanged; a v1 document with a
# plasticity field is refused (the field is v2's)
_ACCEPTED_SCHEMAS = ("repro.experiment/v1", SCHEMA)

_MODEL_FIELDS = {f.name for f in dataclasses.fields(MicrocircuitConfig)}


def _model_from_dict(d: dict) -> MicrocircuitConfig:
    unknown = set(d) - _MODEL_FIELDS
    if unknown:
        raise ValueError(f"unknown model field(s) {sorted(unknown)} "
                         f"(known: {sorted(_MODEL_FIELDS)})")
    return MicrocircuitConfig(**d)


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A declarative, serializable simulation experiment.

    ``stimulus`` entries are kind names, spec dicts or
    :class:`~repro_torch.core.stimulus.Stimulus` instances; an empty
    timeline means the model's default (the 8 Hz Poisson background).
    ``plasticity`` is a rule kind name, spec dict or
    :class:`~repro_torch.core.plasticity.PlasticityRule` (``None``: static
    synapses).  ``validate`` adds a ``spike_stats`` stream probe over
    ``sample_per_pop`` neurons a population and judges the run, pooled
    across trials, against the microcircuit's bands.
    """
    model: MicrocircuitConfig = dataclasses.field(
        default_factory=MicrocircuitConfig)
    stimulus: Tuple = ()
    plasticity: Optional[object] = None
    probes: Tuple[str, ...] = ("pop_counts",)
    duration_ms: float = 1000.0
    trials: int = 1
    validate: bool = False
    backend: str = "fused"
    sample_per_pop: int = 100
    name: str = ""

    def __post_init__(self):
        object.__setattr__(
            self, "stimulus",
            stimulus_mod.resolve_timeline(self.stimulus) if self.stimulus
            else ())
        if self.plasticity is not None:
            object.__setattr__(
                self, "plasticity",
                plasticity_mod.resolve_rule(self.plasticity))
        object.__setattr__(self, "probes", tuple(self.probes))
        if int(self.trials) < 1:
            raise ValueError(f"trials must be >= 1, got {self.trials}")

    # -- serialization (schema repro.experiment/v2) -------------------------

    def to_dict(self) -> dict:
        for p in self.probes:
            if not isinstance(p, str):
                raise ValueError(
                    f"only named probes serialize; got {type(p)} -- keep "
                    f"callable probes for in-process Simulator use")
        if self.model.stimulus is not None:
            raise ValueError("serialize the timeline on Experiment."
                             "stimulus, not on the model config")
        model = dataclasses.asdict(self.model)
        model.pop("stimulus", None)
        # kernels=None ("auto") is left out, so files from before the
        # kernel policy round-trip verbatim; when set, it is a mode string
        if model.get("kernels") is None:
            model.pop("kernels", None)
        elif not isinstance(self.model.kernels, str):
            raise ValueError(
                "scenarios serialize kernels= as a mode string "
                "('auto'/'fused'/'split'/'reference'); pass KernelPolicy "
                "objects to Simulator directly")
        return {
            "schema": SCHEMA,
            "name": self.name,
            "model": model,
            "stimulus": [s.to_dict() for s in self.stimulus],
            "plasticity": (None if self.plasticity is None
                           else self.plasticity.to_dict()),
            "probes": list(self.probes),
            "duration_ms": float(self.duration_ms),
            "trials": int(self.trials),
            "validate": bool(self.validate),
            "backend": self.backend,
            "sample_per_pop": int(self.sample_per_pop),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Experiment":
        d = dict(d)
        schema = d.pop("schema", None)
        if schema not in _ACCEPTED_SCHEMAS:
            raise ValueError(f"unknown experiment schema {schema!r} "
                             f"(accepted: {list(_ACCEPTED_SCHEMAS)})")
        if schema != SCHEMA and d.get("plasticity") is not None:
            raise ValueError(
                f"the plasticity field is a {SCHEMA!r} addition; this "
                f"document declares {schema!r} -- bump its schema")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown experiment field(s) "
                             f"{sorted(unknown)} (known: {sorted(known)})")
        if "model" in d:
            d["model"] = _model_from_dict(dict(d["model"]))
        if "stimulus" in d:
            d["stimulus"] = tuple(
                stimulus_mod.Stimulus.from_dict(s) for s in d["stimulus"])
        if d.get("plasticity") is not None:
            d["plasticity"] = plasticity_mod.resolve_rule(d["plasticity"])
        return cls(**d)

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        s = json.dumps(self.to_dict(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_json(cls, path: str) -> "Experiment":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- execution ----------------------------------------------------------

    def make_simulator(self, connectome=None, *, backend=None,
                       **sim_kwargs):
        """The :class:`Simulator` this experiment declares (model,
        stimulus, probes, and the ``spike_stats`` probe when ``validate``
        is set), for callers that drive the session themselves
        (``run_chunked``, checkpoints).  ``connectome`` reuses a built
        network.  ``backend`` replaces the experiment's backend name with
        a :class:`~repro_torch.api.backends.Backend` instance; one already
        built for this network and config is shared, not rebuilt.  The
        device (``sim_kwargs["device"]``, the card when absent) is checked
        before the network is built."""
        from repro_torch import validate as V
        from repro_torch.api.probes import spike_stats
        from repro_torch.api.simulator import Simulator, session_device
        from repro_torch.core.connectivity import build_connectome

        sim_kwargs["device"] = session_device(
            sim_kwargs.get("device"),
            sharded=(self.backend if backend is None else backend)
            == "sharded")
        model = self.model
        if connectome is None:
            connectome = build_connectome(
                scale=model.scale, n_scaling=model.n_scaling,
                k_scaling=model.k_scaling, seed=int(model.seed), dt=model.dt)
        probes: List = list(self.probes)
        if self.validate:
            ids = V.sample_ids(connectome.pop_sizes,
                               per_pop=self.sample_per_pop,
                               seed=int(model.seed))
            probes.append(
                spike_stats(ids, bin_steps=max(1, round(2.0 / model.dt))))
        if backend is None:
            backend = self.backend
            plasticity = self.plasticity
        else:
            # an instance carries its own plasticity rule
            plasticity = self.plasticity if getattr(
                backend, "plasticity", None) is not None else None
        return Simulator(model, connectome=connectome, backend=backend,
                         probes=probes, stimulus=self.stimulus or None,
                         plasticity=plasticity, **sim_kwargs)

    def run(self, *, connectome=None, warmup: bool = False,
            **sim_kwargs) -> "ExperimentResult":
        """Build the session, simulate ``trials`` x ``duration_ms`` and
        validate.  ``connectome`` reuses a built network; ``warmup=True``
        captures the graphs first, so that the RTF leaves the capture out;
        ``sim_kwargs`` go to :meth:`make_simulator` (``device=``,
        ``backend=``, ``kernels=``)."""
        sim = self.make_simulator(connectome, **sim_kwargs)
        if self.trials == 1:
            if warmup:
                sim.warmup(self.duration_ms)
            res = sim.run(self.duration_ms)
            batch = BatchResult(trials=[res], wall_s=res.wall_s,
                                vmapped=False, seeds=[int(self.model.seed)])
        else:
            if warmup:
                sim.warmup_batch(self.duration_ms, self.trials)
            batch = sim.run_batch(self.duration_ms, self.trials)
        report = batch.validate() if self.validate else None
        return ExperimentResult(experiment=self, batch=batch, report=report)


@dataclasses.dataclass
class ExperimentResult:
    """The trials' results and the across-trial validation verdict."""
    experiment: Experiment
    batch: BatchResult
    report: Optional[object] = None     # ValidationReport when validated

    @property
    def trials(self) -> List[RunResult]:
        return self.batch.trials

    @property
    def connectome(self):
        return self.batch.trials[0]._connectome

    @property
    def passed(self) -> bool:
        """True when validation passed (or was not asked for)."""
        return self.report is None or self.report.passed

    def summary(self) -> dict:
        out = {
            "name": self.experiment.name,
            "n_trials": len(self.batch),
            "t_model_ms": sum(r.t_model_ms for r in self.batch),
            "wall_s": self.batch.wall_s,
            "rtf_mean": self.batch.rtf_mean,
            "rtf_std": self.batch.rtf_std,
            "vmapped": self.batch.vmapped,
            "overflow": sum(r.overflow for r in self.batch),
            "device": self.batch.trials[0].device,
        }
        if self.report is not None:
            out["validation_passed"] = self.report.passed
        return out


def main(argv=None) -> int:
    """The scenario CLI: load a JSON scenario, run it, gate on its
    validation (exit code 4 when it fails)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Run a repro.experiment/v2 scenario JSON on the card")
    ap.add_argument("scenario", help="path to the scenario JSON")
    ap.add_argument("--duration-ms", type=float, default=None,
                    help="override the scenario duration")
    ap.add_argument("--trials", type=int, default=None,
                    help="override the scenario trial count")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="write the ValidationReport JSON here")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain PyTorch versions on "
                         "the CPU; the default is the CUDA card, and no "
                         "card is an error")
    args = ap.parse_args(argv)

    from repro_torch.api.simulator import session_device
    device = session_device(args.device)
    exp = Experiment.from_json(args.scenario)
    overrides = {}
    if args.duration_ms is not None:
        overrides["duration_ms"] = args.duration_ms
    if args.trials is not None:
        overrides["trials"] = args.trials
    if overrides:
        exp = dataclasses.replace(exp, **overrides)

    result = exp.run(device=device)
    for k, v in result.summary().items():
        print(f"{k}: {v}")
    if result.report is not None:
        print(result.report.table())
        if args.report_json:
            result.report.to_json(args.report_json)
            print("report written:", args.report_json)
        if not result.report.passed:
            return 4
    return 0
