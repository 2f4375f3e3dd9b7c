"""The world a sharded run spans: the counterpart of the reference's
``launch/mesh.make_mesh_auto`` for the sharded backend.

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

A run over P processes, one card each::

    torchrun --nproc-per-node=P script.py      # in script.py:
    torch.distributed.init_process_group("nccl")
    sim = Simulator(MicrocircuitConfig(scale=1.0, strategy="ell"),
                    backend="sharded")         # on cuda:{LOCAL_RANK}
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


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
        world of one without a group."""
        if self.group is None:
            return x
        out = torch.empty(self.size * x.shape[0], dtype=x.dtype,
                          device=x.device)
        _all_gather(out, x.contiguous(), self.group)
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
