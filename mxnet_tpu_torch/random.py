"""Random number state.

Counterpart of `mxnet_tpu/random.py`. ``seed(n)`` seeds everything the
port draws from:

- numpy's global generator, which the initializers draw from
  (`initializer.py`), in the same order as the JAX package's, so one
  seed gives bit-identical parameters in both packages;
- the executors' ``torch.Generator`` seeds: each executor bound after
  ``seed(n)`` takes the next seed of a sequence fixed by ``n``, and seeds
  one generator per forward from it (the JAX package folds a fresh key
  into each forward instead). ``torch``'s and JAX's generators give
  different bits from one seed, so random ops (dropout) agree between the
  packages in distribution only.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["seed", "executor_seed"]

_MASK = (1 << 63) - 1


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.seed = 0
        self.executors = 0


_STATE = _State()


def seed(seed_state):
    """Reset numpy's global generator and the executor seed sequence."""
    seed_state = int(seed_state)
    np.random.seed(seed_state)
    with _STATE.lock:
        _STATE.seed = seed_state
        _STATE.executors = 0


def executor_seed():
    """The next executor's generator seed (a 63-bit mix of the seed and
    the executor's index since the last ``seed``)."""
    with _STATE.lock:
        n = _STATE.executors
        _STATE.executors += 1
        base = _STATE.seed
    return (base * 0x9E3779B97F4A7C15 + (n + 1) * 0xBF58476D1CE4E5B9) & _MASK
