"""The device a session or a core entry point runs on.

The port runs on a CUDA card unless the caller asks for the CPU: with no
device given and no card, ``session_device`` raises instead of carrying on
on the CPU.  ``repro_torch.api.simulator`` re-exports it.
"""
from __future__ import annotations

import torch

from repro_torch.launch import mesh


def session_device(device=None, sharded: bool = False) -> torch.device:
    """``device``, or ``cuda`` when None -- which raises without CUDA; for
    a ``sharded`` session in a process group, this rank's card
    (``launch.mesh.rank_device``).  A card is named with its index, as the
    session's tensors report it."""
    if device is None and sharded:
        return mesh.rank_device(session_device())
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
