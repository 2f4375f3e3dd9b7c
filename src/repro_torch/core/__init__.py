"""Core of the port: model parameters, connectome, neuron, delivery,
stimulus and the engine, exported under the reference's names
(``repro/core/__init__.py``).

The names are bound at first use (a module ``__getattr__``): the kernels
import ``repro_torch.core.neuron``, and the engine imports the kernels, so
an eager import here would make importing a kernel module first a cycle.
"""
import importlib

#: exported name -> (module of repro_torch.core, attribute; None for the
#: module itself)
_EXPORTS = {
    "Connectome": ("connectivity", "Connectome"),
    "build_connectome": ("connectivity", "build_connectome"),
    "Network": ("engine", "Network"),
    "PhaseRunner": ("engine", "PhaseRunner"),
    "SimConfig": ("engine", "SimConfig"),
    "SimState": ("engine", "SimState"),
    "simulate": ("engine", "simulate"),
    "resolve_sim_config": ("engine", "resolve_sim_config"),
    "NeuronParams": ("neuron", "NeuronParams"),
    "NeuronState": ("neuron", "NeuronState"),
    "Propagators": ("neuron", "Propagators"),
    "lif_step": ("neuron", "lif_step"),
    "params": ("params", None),
    "recording": ("recording", None),
    "DeliveryOverflowError": ("delivery", "DeliveryOverflowError"),
    "DeliveryStrategy": ("delivery", "DeliveryStrategy"),
    "available_strategies": ("delivery", "available_strategies"),
    "get_strategy": ("delivery", "get_strategy"),
    "stimulus": ("stimulus", None),
    "Stimulus": ("stimulus", "Stimulus"),
    "Drive": ("stimulus", "Drive"),
    "PoissonBackground": ("stimulus", "PoissonBackground"),
    "DCInput": ("stimulus", "DCInput"),
    "StepCurrent": ("stimulus", "StepCurrent"),
    "ThalamicPulses": ("stimulus", "ThalamicPulses"),
    "available_stimuli": ("stimulus", "available_stimuli"),
    "compile_drive": ("stimulus", "compile_drive"),
    "resolve_timeline": ("stimulus", "resolve_timeline"),
    "register_stimulus": ("stimulus", "register"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    module, attr = _EXPORTS[name]
    value = importlib.import_module(f"{__name__}.{module}")
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
