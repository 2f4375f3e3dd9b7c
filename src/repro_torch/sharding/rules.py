"""Logical-axis sharding rules with divisibility-aware resolution.

The port's counterpart of ``repro.sharding.rules``.  Every parameter and
activation carries a tuple of *logical* axis names; the rules map a
logical axis to its (ordered) candidate mesh axes.  :func:`resolve` turns
an axes tuple and a concrete shape into one torch placement per mesh dim
(``Shard(i)`` or ``Replicate()``, what a ``DTensor`` on a ``DeviceMesh``
takes), dropping candidates that do not divide the dimension or that
another dimension of the same tensor already uses, so that one rule set
serves every shape without special cases.  :func:`partition_spec` gives
the same resolution in the reference's ``PartitionSpec`` tuple form (a
mesh axis name, a tuple of them, or None per tensor dim; trailing Nones
trimmed), and :func:`spec_of` reads that form back from placements.

Parallelism map (the reference's):
  * batch           -> ('pod', 'data')   data parallel across pods and hosts
  * embed (weights) -> 'data'            FSDP: parameters sharded
  * mlp/heads/vocab/experts -> 'model'   tensor/expert parallel within pod
  * kv_seq          -> 'model'           context parallel for decode caches

A mesh is anything with named dims (:func:`mesh_axes`): a
``DeviceMesh``, a ``launch.mesh.MeshLayout``, or an object with the
reference mesh's ``axis_names`` and ``devices.shape``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

Rules = Dict[str, Tuple[str, ...]]

PARAM_RULES: Rules = {
    "embed": ("data",),          # FSDP axis
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "head_dim": (),
    "rec_in": ("model",),        # sLSTM recurrent-matrix input dim
    "layers": (),
    "pos": (),
    "state": (),
    "conv": (),
}

ACT_RULES: Rules = {
    "batch": ("pod", "data"),
    # sequence parallelism for inter-block residuals
    "seq": ("model",),
    "kv_seq": ("model",),
    "embed": (),
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "experts": ("model",),
    "layers": (),
    "state": (),
    "conv": (),
    "pos": (),
}

# Logical axes of the decode caches / recurrent states, by leaf name.
CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "ck": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "cv": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "conv": ("layers", "batch", "conv", "mlp"),
    "ssm": ("layers", "batch", "mlp", "state"),
    "C": ("layers", "batch", "heads", "head_dim", "head_dim"),
    "n": ("layers", "batch", "heads", "head_dim"),
    "m": ("layers", "batch", "heads"),
    "c": ("layers", "batch", "heads", "head_dim"),
    "h": ("layers", "batch", "heads", "head_dim"),
}

SMALL_PARAM_BYTES = 64 << 20   # replicate below this (norms, routers, gates)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(names, sizes)`` of a mesh's dims: a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape``, a layout's or the reference mesh's
    ``axis_names`` and ``shape`` (``devices.shape`` for the latter)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    devices = getattr(mesh, "devices", None)
    shape = mesh.shape if devices is None else devices.shape
    return tuple(names), tuple(shape)


def _assign(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
            rules: Rules) -> list:
    """Per tensor dim, the mesh axes it is split over (the reference's
    ``resolve``, ``rules.py:77``)."""
    names, dims = mesh_axes(mesh)
    sizes = dict(zip(names, dims))
    used: set = set()
    out = []
    for name, dim in zip(axes, shape):
        assignment: Tuple[str, ...] = ()
        if name:
            cands = tuple(a for a in rules.get(name, ())
                          if a in sizes and a not in used)
            # longest prefix of candidates whose product divides dim
            for k in range(len(cands), 0, -1):
                prod = math.prod(sizes[a] for a in cands[:k])
                if prod > 1 and dim % prod == 0:
                    assignment = cands[:k]
                    break
        used.update(assignment)
        out.append(assignment)
    return out


def partition_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                   mesh, rules: Rules) -> tuple:
    """The resolution in the reference's ``PartitionSpec`` tuple form."""
    out = [None if not a else a[0] if len(a) == 1 else a
           for a in _assign(axes, shape, mesh, rules)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def resolve(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
            rules: Rules) -> tuple:
    """Logical axes + shape -> one placement per mesh dim under ``rules``:
    ``Shard(i)`` where tensor dim ``i`` is split over that mesh dim,
    ``Replicate()`` elsewhere."""
    names, _ = mesh_axes(mesh)
    where = {a: i for i, assigned in enumerate(_assign(axes, shape, mesh,
                                                       rules))
             for a in assigned}
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


def spec_of(placements: Sequence, mesh) -> tuple:
    """Placements read back in the ``PartitionSpec`` tuple form (the mesh
    axes splitting one tensor dim in mesh order)."""
    names, _ = mesh_axes(mesh)
    by_dim: Dict[int, list] = {}
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            by_dim.setdefault(p.dim, []).append(name)
    out = [None] * (max(by_dim) + 1 if by_dim else 0)
    for d, a in by_dim.items():
        out[d] = a[0] if len(a) == 1 else tuple(a)
    return tuple(out)


def local_shape(shape: Sequence[int], placements: Sequence, mesh) -> tuple:
    """One rank's block of a tensor of ``shape`` placed by ``placements``:
    each sharded dim divided by the sizes of the mesh dims that split it
    (which must divide it)."""
    out = list(shape)
    for size, p in zip(mesh_axes(mesh)[1], placements):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {size}")
            out[p.dim] //= size
    return tuple(out)


def replicated(mesh) -> tuple:
    """Every mesh dim ``Replicate()``."""
    return tuple(Replicate() for _ in mesh_axes(mesh)[0])


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _zip_map(fn, axes_tree, shape_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree, shape_tree)
    if isinstance(axes_tree, dict):
        return {k: _zip_map(fn, v, shape_tree[k])
                for k, v in axes_tree.items()}
    return type(axes_tree)(_zip_map(fn, a, s)
                           for a, s in zip(axes_tree, shape_tree))


def param_sharding(axes_tree, shape_tree, mesh):
    """Placements for a parameter tree (FSDP + tensor-parallel rules).
    ``shape_tree`` holds tensors (``meta`` ones will do); tensors of at
    most ``SMALL_PARAM_BYTES`` are replicated (sharding a small router
    costs a collective per use and saves almost no memory)."""
    def one(a, s):
        if math.prod(s.shape) * s.dtype.itemsize <= SMALL_PARAM_BYTES:
            return replicated(mesh)
        return resolve(a, s.shape, mesh, PARAM_RULES)
    return _zip_map(one, axes_tree, shape_tree)


def _leaf_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _leaf_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_leaf_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_sharding(batch_specs, mesh):
    """Every batch input split over ('pod', 'data') on dim 0."""
    def one(_, s):
        ax = ("batch",) + (None,) * (len(s.shape) - 1)
        return resolve(ax, s.shape, mesh, ACT_RULES)
    return _leaf_map(one, batch_specs)


def cache_sharding(cache_tree, mesh):
    """Placements for the decode caches, by leaf name (``CACHE_AXES``)."""
    def one(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        axes = CACHE_AXES.get(name)
        if axes is None or len(axes) != len(leaf.shape):
            axes = ("layers", "batch") + (None,) * (len(leaf.shape) - 2)
        return resolve(axes, leaf.shape, mesh, ACT_RULES)
    return _leaf_map(one, cache_tree)
