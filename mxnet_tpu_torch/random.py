"""Random number state.

Counterpart of `mxnet_tpu/random.py`. ``seed(n)`` seeds everything the
port draws from:

- numpy's global generator, which the initializers draw from
  (`initializer.py`), in the same order as the JAX package's, so one
  seed gives bit-identical parameters in both packages;
- the seed sequence of the ``torch.Generator``s: each executor bound
  after ``seed(n)`` takes the next seed of a sequence fixed by ``n`` and
  seeds one generator per forward from it, and each eager random op
  (``nd.random``, `ops/invoke.py`) seeds its own generator from the next
  seed of the same sequence. ``seed(n, ctx)`` with one context starts a
  sequence of that device's own, as the JAX package reseeds one device's
  key chain; ``ctx="all"`` drops those and restarts the shared one. One
  seed reproduces the port's draws bit for bit. ``torch``'s and JAX's
  generators give different bits from one seed, so random ops agree
  between the packages in distribution only.

A hybridized Gluon call draws from one seed a call (its ``key``), handed
to the ops inside it through :class:`key_scope`.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["seed", "executor_seed", "op_seed", "key_scope"]

_MASK = (1 << 63) - 1


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.seed = 0
        self.executors = 0
        self.devices = {}       # Context -> [seed, draws since seed]


_STATE = _State()
_SCOPE = threading.local()


def _mix(base, n):
    return (base * 0x9E3779B97F4A7C15 + (n + 1) * 0xBF58476D1CE4E5B9) & _MASK


def seed(seed_state, ctx="all"):
    """Reset the seed sequences (reference ``mx.random.seed``): every
    device's and numpy's global generator with ``ctx="all"``, else only
    the sequence of the device ``ctx`` names."""
    seed_state = int(seed_state)
    if ctx == "all":
        np.random.seed(seed_state)
    with _STATE.lock:
        if ctx == "all":
            _STATE.seed = seed_state
            _STATE.executors = 0
            _STATE.devices.clear()
        else:
            _STATE.devices[ctx] = [seed_state, 0]


def executor_seed(ctx=None):
    """The next generator seed of ``ctx``'s sequence (the shared one
    unless ``seed`` gave that device its own): a 63-bit mix of the seed
    and the number of seeds drawn since it was set."""
    with _STATE.lock:
        stream = _STATE.devices.get(ctx)
        if stream is None:
            base, n = _STATE.seed, _STATE.executors
            _STATE.executors += 1
        else:
            base, n = stream
            stream[1] += 1
    return _mix(base, n)


def op_seed(ctx=None):
    """The seed of one eager random op: inside a :class:`key_scope`, the
    next of the scope's own sequence; else ``executor_seed(ctx)``."""
    scope = getattr(_SCOPE, "value", None)
    if scope is None:
        return executor_seed(ctx)
    key, n = scope
    _SCOPE.value = (key, n + 1)
    return _mix(key, n)


class key_scope:
    """Route :func:`op_seed` to a sequence derived from ``key`` (an int),
    as the JAX package's ``key_scope`` routes ``next_key``: a hybridized
    call's random ops draw from the call's key."""

    def __init__(self, key):
        self._key = int(key) & _MASK
        self._saved = None

    def __enter__(self):
        self._saved = getattr(_SCOPE, "value", None)
        _SCOPE.value = (self._key, 0)
        return self

    def __exit__(self, *exc):
        _SCOPE.value = self._saved
        return False
