"""Checkpoints of a session: save, restore, an asynchronous save.

The port's counterpart of ``repro/checkpoint/checkpointer.py``, with its
layout on disk: ``<directory>/step_%08d/host_0.npz`` holds the arrays and
``manifest.json`` the schema (``repro.checkpoint/v1``), the step and each
leaf's shape and dtype.  A checkpoint is written under ``.tmp`` and then
renamed (an atomic publish); ``keep`` bounds how many stay, the oldest
going first.

A tree of NamedTuples, tuples, lists and dicts of tensors flattens under
the JAX package's leaf names: a dict key as ``['state']``, a field as
``.neuron``, an index as ``[0]``, joined by ``||``, so a static session's
``['state']||.neuron||.V`` is the same leaf in both packages.  A
``torch.Generator`` leaf is stored as its ``get_state()`` bytes, where the
reference stores its ``key``: a resumed run then draws the Poisson counts
the uninterrupted run would have drawn.  ``None`` is no leaf.  A bfloat16
tensor is stored as float32 (numpy has no bfloat16), exactly; its manifest
entry says ``bfloat16``, as the reference's does.

Before any array is read, ``restore`` checks the manifest against the
target and raises :class:`CheckpointMismatchError` naming a missing
manifest or an unknown schema, the leaves missing or extra, or the leaf
whose shape or stored dtype differs.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "||"

CKPT_SCHEMA = "repro.checkpoint/v1"


class CheckpointMismatchError(ValueError):
    """A checkpoint cannot be restored into the requested target: no
    manifest or an unknown schema, the leaf set differs, or a leaf's shape
    or dtype differs."""


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, torch.Generator, np.ndarray,
                          np.generic))


def _items(tree: Any, path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """``(name, leaf)`` of every leaf, in the tree's order."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield _SEP.join(path), tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field, v in zip(tree._fields, tree):
            yield from _items(v, path + (f".{field}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (f"[{i}]",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (f"[{k!r}]",))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{_SEP.join(path) or 'the root'}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        # a copy, never a view of a CPU tensor that runs on
        leaf = leaf.detach().to("cpu", copy=True)
        return (leaf.float() if leaf.dtype == torch.bfloat16
                else leaf).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict:
    """Every leaf of ``tree`` as a host numpy array, by name."""
    return {name: _to_numpy(leaf) for name, leaf in _items(tree)}


def _shape(leaf) -> tuple:
    if isinstance(leaf, torch.Generator):
        return tuple(leaf.get_state().shape)
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)


def _dtype(leaf) -> str:
    """The leaf's dtype under numpy's name (``bfloat16`` for bfloat16)."""
    if isinstance(leaf, torch.Generator):
        return "uint8"
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _dtypes(tree: Any) -> dict:
    return {name: _dtype(leaf) for name, leaf in _items(tree)}


def step_path(directory: str, step: int) -> str:
    """Where the checkpoint of ``step`` lives under ``directory``."""
    return os.path.join(directory, f"step_{step:08d}")


def _write_checkpoint(directory: str, arrays: dict, dtypes: dict,
                      step: int, keep: int) -> str:
    """Write the arrays and the manifest, publish atomically, drop all but
    the newest ``keep``."""
    path = step_path(directory, step)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "host_0.npz"), **arrays)
    manifest = {
        "schema": CKPT_SCHEMA,
        "step": int(step),
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)           # atomic publish
    _gc(directory, keep)
    return path


def save(state: Any, directory: str, step: int, keep: int = 3) -> str:
    """Blocking save; returns the checkpoint's path."""
    return _write_checkpoint(directory, _flatten(state), _dtypes(state),
                             step, keep)


class AsyncCheckpointer:
    """Saves written on a worker thread: ``save`` copies the tree to the
    host (synchronously, so the caller may change it at once) and the file
    is written behind it; ``wait`` joins the write."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Any, step: int) -> None:
        arrays, dtypes = _flatten(state), _dtypes(state)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(arrays, dtypes, step), daemon=True)
        self._thread.start()

    def _write(self, arrays, dtypes, step) -> None:
        try:
            _write_checkpoint(self.directory, arrays, dtypes, step,
                              self.keep)
        except BaseException as e:       # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _validate_manifest(path: str, target_leaves: dict) -> None:
    """Schema, leaf set, shapes and dtypes (``target_leaves``: name ->
    (shape, dtype)) against the manifest; a mismatch raises
    :class:`CheckpointMismatchError` naming it."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise CheckpointMismatchError(
            f"{path}: no manifest.json, so no {CKPT_SCHEMA!r} checkpoint")
    with open(manifest_path) as f:
        manifest = json.load(f)
    schema = manifest.get("schema")
    if schema != CKPT_SCHEMA:
        raise CheckpointMismatchError(
            f"{path}: unknown checkpoint schema {schema!r} (this build "
            f"reads {CKPT_SCHEMA!r}); the checkpoint was written by an "
            f"incompatible version -- re-save it, or restore with the "
            f"version that wrote it")
    stored = manifest.get("leaves", {})
    missing = sorted(set(target_leaves) - set(stored))
    extra = sorted(set(stored) - set(target_leaves))
    if missing or extra:
        raise CheckpointMismatchError(
            f"{path}: checkpoint structure does not match the restoring "
            f"session (leaves missing from checkpoint: {missing or 'none'}"
            f"; leaves only in checkpoint: {extra or 'none'}); "
            f"config/backend must equal the saving session's")
    for key, (want_shape, want_dtype) in target_leaves.items():
        got = tuple(stored[key]["shape"])
        if got != tuple(want_shape):
            raise CheckpointMismatchError(
                f"{path}: leaf {key!r} has shape {got} in the checkpoint "
                f"but {tuple(want_shape)} in the restoring session -- "
                f"config/backend (network scale, strategy, plasticity) "
                f"must equal the saving session's")
        if stored[key]["dtype"] != want_dtype:
            raise CheckpointMismatchError(
                f"{path}: leaf {key!r} is {stored[key]['dtype']} in the "
                f"checkpoint but {want_dtype} in the restoring session -- "
                f"config (state_dtype) must equal the saving session's")


def _like(arr: np.ndarray, target):
    """``arr`` in the form of the target leaf: a tensor on its device in
    its dtype, a generator with the stored state, or numpy."""
    if isinstance(target, torch.Generator):
        gen = torch.Generator(device=target.device)
        gen.set_state(torch.from_numpy(np.array(arr, np.uint8)))
        return gen
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=target.device, dtype=target.dtype)
    return np.asarray(arr).astype(np.asarray(target).dtype)


def _rebuild(tree: Any, values: Iterator) -> Any:
    """``tree`` with each leaf replaced by the next of ``values`` (in
    ``_items``' order)."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return next(values)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, values) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return {k: _rebuild(tree[k], values) for k in sorted(tree)}


def restore(directory: str, target: Any, step: Optional[int] = None) -> Any:
    """The checkpoint at ``step`` (the latest when None) in the structure
    of ``target``, whose values are ignored: each tensor on the target's
    device in its dtype, each generator a new one holding the stored
    state.  Raises :class:`CheckpointMismatchError` when the schema, the
    leaves, a shape or a dtype do not match ``target``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = step_path(directory, step)
    items = list(_items(target))
    _validate_manifest(path, {name: (_shape(leaf), _dtype(leaf))
                              for name, leaf in items})
    with np.load(os.path.join(path, "host_0.npz")) as data:
        values = [_like(data[name], leaf) for name, leaf in items]
    return _rebuild(target, iter(values))


def _gc(directory: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for d in os.listdir(directory)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(step_path(directory, s), ignore_errors=True)
