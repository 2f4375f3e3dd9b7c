"""KernelPolicy: which hand-written kernels run the hot loop.

The port's counterpart of ``repro.core.kernel_policy``.  ``SimConfig.
kernels`` (or ``Simulator(kernels=...)``) takes a mode string, and
``resolve_sim_config`` resolves it exactly once against the session's
device and connectome into a ``KernelPolicy``; every field is concrete.

Modes
-----
``auto``       on ``cuda``: the fused one-kernel step (K3, or K4 and
               ``stdp_update`` for a ``pair_stdp`` run) for the ``ell``
               strategy with float32 state, the split kernels (K1, plus
               K2 for ``ell`` or K5 for ``dense``, and ``stdp_update`` for
               a plastic run) otherwise.  On the CPU: the plain PyTorch
               versions.
``fused``      force the fused step.  Raises unless strategy == "ell",
               float32 state, and no plasticity or ``pair_stdp``.
``split``      force the per-phase kernels (``lif_update`` + delivery).
``reference``  the plain PyTorch versions on any device (``lif_step`` +
               ``index_add_`` delivery, or for ``dense`` two
               ``torch.matmul`` GEMVs on the source-major table) -- only
               when asked for by name.

The ``deliver`` field names what scatters the spikes: ``kernel`` (K2/K3
for ``ell``, K5 on the bin-major table for ``dense``), ``index_add``
(``event``, and ``ell`` without kernels), or ``matmul`` (``dense``
without kernels: the GEMM layout, a plain large product that the
reference too leaves outside any kernel).

The reference's TPU rules are gone: the card has no VMEM cap on the ring
(the JAX ``auto`` on a TPU falls back to split with XLA delivery at full
scale, where the 28 MB ring exceeds its VMEM gate), and there is no
interpret mode.  The port's rule is "the hand-written kernels on the
card", so its ``auto`` takes K5 for ``dense`` on ``cuda``, where the
reference's ``auto`` on a TPU takes the GEMM.  A wrapper given CPU tensors
runs its plain version, so ``fused`` and ``split`` resolved on the CPU run
the plain versions there.

A policy made by hand (``KernelPolicy(mode="split")``, or ``as_policy`` of
a mode string) is unresolved: ``resolve`` fills it by its mode.  The
reference's per-op overrides (``lif=``, ``deliver=``) and ``interpret``
have no counterpart; nor has ``FUSED_MAX_RING_BYTES``, a TPU VMEM limit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

MODES = ("auto", "fused", "split", "reference")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """A kernel policy; ``resolve`` fills every field of an unresolved
    one (``step`` None)."""
    mode: str = "auto"               # one of MODES, as asked for
    step: Optional[str] = None       # "fused" (K3) | "split" (update +
                                     # deliver phases)
    kernels: Optional[bool] = None   # the hand-written kernels, else the
                                     # plain versions
    deliver: Optional[str] = None    # what scatters spikes: "kernel"
                                     # (K2/K3, K5) | "index_add" | "matmul"
                                     # (dense GEMM)
    plastic: Optional[str] = None    # the plasticity rule's kind, or None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"kernel mode {self.mode!r} not in {MODES}")

    @property
    def resolved(self) -> bool:
        return self.step is not None

    def describe(self) -> str:
        """One-line form, e.g. ``auto[step=fused,lif=kernel,deliver=kernel]``
        or, for a plastic run, ``...,plastic=pair_stdp:kernel]`` (the
        plastic update by its kernel or its plain version)."""
        lif = "kernel" if self.kernels else "plain"
        parts = f"step={self.step},lif={lif},deliver={self.deliver}"
        if self.plastic is not None:
            parts += f",plastic={self.plastic}:{lif}"
        return f"{self.mode}[{parts}]"


def fused_eligible(strategy: str, state_dtype,
                   plastic: Optional[str] = None) -> tuple[bool, str]:
    """(eligible, reason-if-not) for the fused one-kernel step."""
    if strategy != "ell":
        return False, (f"the fused step requires the 'ell' delivery "
                       f"strategy (got {strategy!r})")
    if state_dtype != torch.float32:
        return False, (f"the fused step requires float32 state "
                       f"(got {state_dtype})")
    if plastic not in (None, "pair_stdp"):
        return False, (f"the fused plastic step (K4) is pair STDP's "
                       f"(got the rule {plastic!r})")
    return True, ""


def as_policy(kernels: Union[None, str, KernelPolicy]) -> KernelPolicy:
    """Normalise the ``SimConfig.kernels`` field to a KernelPolicy (a mode
    string or None to an unresolved one)."""
    if kernels is None:
        return KernelPolicy()
    if isinstance(kernels, str):
        return KernelPolicy(mode=kernels)
    if isinstance(kernels, KernelPolicy):
        return kernels
    raise TypeError(f"kernels= takes a mode string {MODES} or a "
                    f"KernelPolicy, got {type(kernels).__name__}")


def resolve(kernels: Union[None, str, KernelPolicy], *, strategy: str,
            state_dtype, device, plastic: Optional[str] = None
            ) -> KernelPolicy:
    """Resolve a mode (None means ``auto``) against the session's device.
    Idempotent: a resolved policy is returned as it is."""
    pol = as_policy(kernels)
    if pol.resolved:
        return pol
    mode = pol.mode
    on_cuda = torch.device(device).type == "cuda"
    eligible, why = fused_eligible(strategy, state_dtype, plastic)
    if mode == "fused" and not eligible:
        raise ValueError(f"kernels='fused': {why}")
    fused = mode == "fused" or (mode == "auto" and on_cuda and eligible)
    use = mode in ("fused", "split") or (mode == "auto" and on_cuda)
    # ell and dense have a delivery kernel; event is index_add_, dense
    # without kernels the GEMM
    if use and strategy in ("ell", "dense"):
        deliver = "kernel"
    else:
        deliver = "matmul" if strategy == "dense" else "index_add"
    return KernelPolicy(mode=mode, step="fused" if fused else "split",
                        kernels=use, deliver=deliver, plastic=plastic)


def policy_of(cfg) -> Optional[KernelPolicy]:
    """The resolved policy carried by a SimConfig, or None."""
    pol = getattr(cfg, "kernels", None)
    return pol if isinstance(pol, KernelPolicy) and pol.resolved else None
