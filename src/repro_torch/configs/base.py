"""The configuration registry: the language-model configuration that the
attention and MLP layers (``repro_torch.models.layers``) read, the input
shapes, and the registry of architectures the launchers select by id.

The port's copy of ``repro.configs.base.ModelConfig`` for those layers:
the widths they are built at and the fields and properties they read
(``head_dim_``, ``use_rope``, ``qk_norm``, ``norm_eps``, ``rope_theta``,
``dtype``), with the reference's names and defaults.  ``dtype`` stays a
string, as in the reference; ``activation_dtype`` gives it as a torch
dtype.  The reference's family, vocabulary, parameter dtype, MoE, hybrid,
encoder and training fields serve models the port does not have.

The registry is the reference's (``repro/configs/base.py:97-146``), with
its names and values: ``SHAPES`` (the LM input shapes), ``ARCH_IDS`` (the
microcircuit, the one architecture left), ``get_config`` /
``get_smoke_config`` (an id to its module's ``CONFIG`` / ``SMOKE``) and
``cells``.  The dry run (``repro_torch.launch.dryrun``) reads it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def use_rope(self) -> bool:
        """Rotary positions in self-attention.  Always: the reference
        leaves them out only for its encoder-decoder family (learned
        positions), which the port has no model of."""
        return True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: the architectures the launchers take (``--arch``): the microcircuit is
#: the one left, as in the reference
ARCH_IDS: Tuple[str, ...] = ("microcircuit",)

_MODULE_OF = {
    "microcircuit": "microcircuit",
}


def get_config(name: str):
    """Resolve an architecture id to its ``CONFIG`` object."""
    if name not in _MODULE_OF:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_OF)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[name]}")
    return mod.CONFIG


def get_smoke_config(name: str):
    """The reduced config of the same architecture, for CPU smoke tests."""
    if name not in _MODULE_OF:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULE_OF)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[name]}")
    return mod.SMOKE


def cells(arch: str):
    """The (arch x shape) cells of one architecture: the ``SHAPES`` its
    config takes, skipping long contexts on a full-attention LM and decode
    shapes on a model without a decoder.  A model that is not a language
    model (the microcircuit) takes none: its dry-run cells are its delivery
    strategies (``launch.dryrun``).  (The reference's ``cells`` asks the
    microcircuit's config for the LM methods it lacks, and raises.)"""
    cfg = get_config(arch)
    if not hasattr(cfg, "supports_long_context"):
        return []
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.supports_long_context():
            continue
        if s.kind == "decode" and not cfg.has_decoder():
            continue
        out.append(s)
    return out
