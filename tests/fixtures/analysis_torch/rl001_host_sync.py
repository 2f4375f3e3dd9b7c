"""RL001 fixture: host syncs in a step-reachable function.

The tests lint this file with a config whose roots match ``hot_step`` /
``hot_caller`` and assert one finding per line carrying an ``RL001``
marker comment (rule id and line are both checked).
"""
import numpy as np
import torch


def hot_step(state, t):
    rate = float(state)                 # RL001: float() on a tensor
    print("step", t)                    # RL001: print()
    host = np.asarray(state)            # RL001: np.asarray() on a tensor
    peak = state.item()                 # RL001: .item()
    n = int(state.sum())                # RL001: int() on a tensor
    live = bool(state.any())            # RL001: bool() on a tensor
    rows = state.tolist()               # RL001: .tolist()
    back = state.cpu()                  # RL001: .cpu()
    arr = back.numpy()                  # RL001: .numpy()
    torch.cuda.synchronize()            # RL001: torch.cuda.synchronize()
    return rate, host, peak, n, live, rows, arr


def helper_called_from_hot(carry):
    return carry.item()                 # RL001: hot via the call graph


def hot_caller(state):
    return helper_called_from_hot(state)


def cold_helper(config):
    # NOT reachable from any root: host syncs here are legitimate
    print("loaded", config)
    return float(np.asarray([1.0])[0])
