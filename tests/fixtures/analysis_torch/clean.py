"""Clean fixture: the hot-path shapes written correctly -- zero findings.

The same patterns as the violation fixtures, in the idioms the port's
lint rules steer towards (``torch.where``, host metadata only in
branches, lock-guarded shared state, float32).
"""
import threading

import torch

_CACHE = {}
_LOCK = threading.Lock()


def hot_step(state, t):
    gain = torch.exp(state)
    state = torch.where(gain > 0.5, state + 1.0, state)
    state = torch.where(t > 0, state, gain)
    if state.shape[0] > 4:              # host metadata
        state = state * 1.0
    if state.device.type == "cuda":     # host metadata
        state = state.contiguous()
    if state is None:                   # identity test is host-side
        return gain
    return state.to(torch.float32)


def remember(key, value):
    with _LOCK:
        _CACHE[key] = value
