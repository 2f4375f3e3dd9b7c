"""The language-model configuration that the attention and MLP layers
(``repro_torch.models.layers``) read.

The port's copy of ``repro.configs.base.ModelConfig`` for those layers:
the widths they are built at and the fields and properties they read
(``head_dim_``, ``use_rope``, ``qk_norm``, ``norm_eps``, ``rope_theta``,
``dtype``), with the reference's names and defaults.  ``dtype`` stays a
string, as in the reference; ``activation_dtype`` gives it as a torch
dtype.  The reference's family, vocabulary, parameter dtype, MoE, hybrid,
encoder and training fields, and its registry of architectures, serve
models the port does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
