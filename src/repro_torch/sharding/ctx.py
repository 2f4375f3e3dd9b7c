"""The ambient mesh.

The port's counterpart of ``repro.sharding.ctx``.  Model code is
mesh-agnostic: a launcher installs a mesh here (:func:`use_mesh`) and the
layers call ``constrain(x, logical_axes)`` at the points where memory
matters.  The resolver (:mod:`repro_torch.sharding.rules`) maps the logical
axes onto whatever mesh is active.  Outside any mesh (one card, the CPU
tests) ``constrain`` is the identity; under one, a ``DTensor`` is
redistributed to the resolved placements (a plain tensor has no
distribution to constrain, and is returned as it is).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.sharding import rules as R

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None) the ambient one for the
    block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[object]:
    return _MESH.get()


def constrain(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` laid out by ``axes`` under the ambient mesh (the identity
    without one, or for a tensor that is not a ``DTensor``)."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = R.resolve(axes, x.shape, mesh, R.ACT_RULES)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
