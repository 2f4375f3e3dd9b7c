"""The world a sharded run spans, and the mesh layouts: the counterpart
of the reference's ``launch/mesh.py``.

A JAX mesh names devices of one process; a ``torch.distributed`` world is
one process per rank.  :func:`make_world` reads it:

* with the default process group initialised, the group's rank and size,
  and the gather of the spike registry is the group's all-gather;
* with none, a world of one, whose gather is the identity (no collective).

:func:`rank_device` is the card a rank runs on: ``cuda:{LOCAL_RANK}``
(``torchrun`` sets it) in a group on a CUDA machine, else the session's
device.  :func:`init_single_process_group` starts a group of one over a
``HashStore`` in this process, which needs no network: a world of one
whose gather is still a collective (NCCL on a card, gloo on the CPU).

A 2-D world of ranks (``data`` x ``model``) is a
``torch.distributed.device_mesh.DeviceMesh``: :func:`make_mesh` lays the
live world out in a shape, :func:`make_host_mesh` as ``(1, size)`` (the
reference's host mesh).  :func:`make_production_mesh` gives the reference's
production layouts, ``(16, 16)`` over ``("data", "model")`` or ``(2, 16,
16)`` over ``("pod", "data", "model")``, as named shapes with no process
behind them (:class:`MeshLayout`): the dry run lays a step out over them on
``meta`` tensors.  :class:`World2d` is a rank's place in a 2-D world and its
two collectives, the dense sharded step's (``core/distributed``).

The hardware constants are the H100 SXM's datasheet values (NVIDIA; dense
rates, no sparsity, at the 700 W limit), in place of the reference's TPU
v5e ones: not measurements.

A run over P processes, one card each::

    torchrun --nproc-per-node=P script.py      # in script.py:
    torch.distributed.init_process_group("nccl")
    sim = Simulator(MicrocircuitConfig(scale=1.0, strategy="ell"),
                    backend="sharded")         # on cuda:{LOCAL_RANK}
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.perf.step_analysis import note_collective

#: the card the constants below describe (datasheet values, not measured)
DEVICE_NAME = "NVIDIA H100 SXM5 80GB (datasheet)"
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12        # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 900e9             # B/s per card, both directions together
HBM_BYTES = 80 * 10 ** 9      # 80 GB


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` = the ranks' ``x`` end to end (newer torch names it
    ``all_gather_single``)."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


@dataclasses.dataclass(frozen=True)
class World:
    """A rank's view of its world: ``rank`` of ``size``, the process group
    (None for a world of one without one)."""
    rank: int = 0
    size: int = 1
    group: Optional[object] = None

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` end to end, rank 0 first; ``x`` itself in a
        world of one without a group.  A world of more without a group is
        a layout (the dry run's): it gives the result's shape on ``meta``
        tensors and refuses real ones."""
        if self.group is None:
            if self.size == 1:
                return x
            if x.device.type != "meta":
                raise RuntimeError(f"a World of {self.size} ranks without "
                                   f"a process group is a layout: its "
                                   f"gather takes meta tensors only")
            out = x.new_empty((self.size * x.shape[0],))
            note_collective("all-gather", out.numel() * out.element_size())
            return out
        out = torch.empty(self.size * x.shape[0], dtype=x.dtype,
                          device=x.device)
        _all_gather(out, x.contiguous(), self.group)
        note_collective("all-gather", out.numel() * out.element_size())
        return out


def group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_world(n_devices: Optional[int] = None) -> World:
    """The default process group's world, or a world of one without it.
    ``n_devices`` (None: the whole world) larger than the world raises
    ``ValueError``; a sharded world is the whole group, so a smaller one
    raises too."""
    if group_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group = dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    n_dev = size if n_devices is None else int(n_devices)
    if n_dev > size:
        raise ValueError(f"n_devices={n_dev} > available {size}")
    if n_dev != size:
        raise ValueError(f"n_devices={n_dev}: a sharded world spans the "
                         f"whole process group ({size} ranks)")
    return World(rank=rank, size=size, group=group)


def rank_device(default: torch.device) -> torch.device:
    """This rank's card in a group on a CUDA machine (``LOCAL_RANK``, else
    the rank modulo the cards), else ``default``."""
    if default.type != "cuda" or not group_initialized():
        return default
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None \
        else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def init_single_process_group(backend: str = "nccl") -> None:
    """Start the default process group as a world of one in this process,
    over a ``HashStore`` (no address, no network).  End it with
    ``torch.distributed.destroy_process_group()``."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


# ---------------------------------------------------------------------------
# Mesh layouts and the 2-D world of the dense sharded step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh as named dims with no process behind it (a production layout
    for the dry run): ``axis_names`` as the reference's mesh names them,
    ``shape`` and ``size()`` as a ``DeviceMesh`` gives them."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """(16, 16) ('data', 'model') per pod; (2, 16, 16) with a 'pod' axis."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_mesh(shape: Tuple[int, int]):
    """The live world (the default process group, whose size must be the
    shape's product) as a ``DeviceMesh`` of ``shape`` over ``("data",
    "model")``, on the cards when the group's backend is NCCL, else on the
    CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    if not group_initialized():
        raise RuntimeError("a mesh spans a process group: initialise one "
                           "(a world of one needs none: World2d())")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape),
                            mesh_dim_names=("data", "model"))


def make_host_mesh():
    """The live world as a 2-D ``DeviceMesh`` of ``(1, size)`` over
    ``("data", "model")``."""
    return make_mesh((1, dist.get_world_size()))


def _gather_dim1(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """``[a, b]`` from each of ``n`` ranks -> ``[a, n * b]``, rank-major
    along dim 1."""
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    _all_gather(out.view(-1), x.contiguous().view(-1), group)
    return out.permute(1, 0, 2).reshape(x.shape[0], n * x.shape[1])


@dataclasses.dataclass(frozen=True)
class World2d:
    """A rank's place in a 2-D world of ``shape = (pre, model)`` ranks:
    ``coord`` is its ``(pre, model)`` index, the groups its row and column.
    The dense sharded step's two collectives are here: the all-reduce over
    the ``data`` (pre) group and the all-gather over the ``model`` group.

    A world of one without groups has identity collectives, as
    ``World.gather`` has.  A world without groups but of more than one rank
    is a layout (:func:`layout_world`): its collectives give their results'
    shapes on ``meta`` tensors and refuse real ones.  Each collective that
    is one (a group, or a layout) reports its result bytes to an open
    ``perf.step_analysis`` (an all-reduce is counted twice there)."""
    shape: Tuple[int, int] = (1, 1)
    coord: Tuple[int, int] = (0, 0)
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    def _layout_only(self, x: torch.Tensor, n: int, group, what: str):
        if group is None and n > 1 and x.device.type != "meta":
            raise RuntimeError(f"World2d {self.shape} without process "
                               f"groups is a layout: its {what} takes "
                               f"meta tensors only")
        return group is not None or n > 1

    def all_reduce_data(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the rank's ``data`` group (in place)."""
        if self._layout_only(x, self.shape[0], self.data_group,
                             "all-reduce"):
            if self.data_group is not None:
                dist.all_reduce(x, group=self.data_group)
            note_collective("all-reduce", x.numel() * x.element_size())
        return x

    def all_gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``[a, b]`` of every rank of the ``model`` group, end to end
        along dim 1: ``[a, model * b]``."""
        n = self.shape[1]
        if not self._layout_only(x, n, self.model_group, "all-gather"):
            return x
        if self.model_group is None:
            out = x.new_empty((x.shape[0], n * x.shape[1]))
        else:
            out = _gather_dim1(x, n, self.model_group)
        note_collective("all-gather", out.numel() * out.element_size())
        return out


def world2d(mesh=None) -> World2d:
    """A rank's :class:`World2d` on a 2-D ``DeviceMesh`` over ``("data",
    "model")``; a world of one without groups when ``mesh`` is None."""
    if mesh is None:
        return World2d()
    names = tuple(mesh.mesh_dim_names)
    if names != ("data", "model"):
        raise ValueError(f"the dense step's mesh is ('data', 'model'), "
                         f"got {names}")
    return World2d(shape=(mesh.size(0), mesh.size(1)),
                   coord=(mesh.get_local_rank("data"),
                          mesh.get_local_rank("model")),
                   data_group=mesh.get_group("data"),
                   model_group=mesh.get_group("model"))


def layout_world(layout: MeshLayout) -> World2d:
    """Rank 0's :class:`World2d` of a production layout (no process
    group): the ``model`` dim, and every other dim flattened into the
    ``pre`` dim, as ``dense_shardings`` shards ``W``."""
    names = tuple(layout.axis_names)
    model = names.index("model")
    pre = math.prod(n for i, n in enumerate(layout.shape) if i != model)
    return World2d(shape=(pre, layout.shape[model]))
