"""RL002 fixture: Python control flow on a tensor's value.

Linted with roots matching ``hot_branch``; the tests assert one finding
per ``RL002`` marker line.
"""
import torch


def hot_branch(state, t):
    gain = torch.exp(state)             # taint: a torch call makes a tensor
    if gain.max() > 0.5:                # RL002: `if` on a tensor
        state = state + 1.0
    while t > 0:                        # RL002: `while` on a tensor
        t = t - 1
    if state.shape[0] > 4:              # host metadata: no finding
        state = state * 1.0
    if state.device.type == "cpu":      # host metadata: no finding
        state = state.clone()
    if state is None:                   # identity test: no finding
        return gain
    return state
