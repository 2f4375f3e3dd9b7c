"""RL005 fixture: module-level mutable state mutated without the lock.

Linted with ``shared_state_scopes`` covering this directory; one finding
per ``RL005`` marker line.
"""
import threading

_REGISTRY = {}
_HISTORY = []
_LOCK = threading.Lock()


def put_unlocked(key, value):
    _REGISTRY[key] = value              # RL005: unlocked subscript write


def log_unlocked(entry):
    _HISTORY.append(entry)              # RL005: unlocked append


def put_locked(key, value):
    with _LOCK:
        _REGISTRY[key] = value          # lock held: no finding
        _HISTORY.append(key)
