"""RL004 fixture: double precision in device-code scope.

Linted with ``dtype_scopes`` covering this directory; one finding per
``RL004`` marker line.
"""
import numpy as np
import torch

KERNEL_TAPS = np.zeros(4, dtype=np.float64)     # RL004: np.float64
ACC_DTYPE = torch.float64                       # RL004: torch.float64
WIDE = torch.double                             # RL004: torch.double


def device_accumulate(x):
    return x.to(ACC_DTYPE).sum()


def host_default(n):
    return torch.zeros(n, dtype=float)          # RL004: dtype=float


def still_single(x):
    return x.to(torch.float32)                  # float32: no finding
