"""The imperative training and recording flags.

Counterpart of the flag half of `mxnet_tpu/autograd.py` (reference
`python/mxnet/autograd.py`): ``is_training``/``is_recording`` and the
scopes ``record``, ``pause``, ``train_mode`` and ``predict_mode``, per
thread. The imperative front end (`ops/invoke.py`) hands ``is_training()``
to the ops that read a train flag (BatchNorm). The tape itself
(``backward``, ``grad``, ``mark_variables``, ``Function``) is not ported
yet: ``record()`` sets the flags but records nothing.
"""
from __future__ import annotations

import threading

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training"]


class _State(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False


_STATE = _State()


class _Scope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training
        self._saved = None

    def __enter__(self):
        self._saved = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._saved
        return False


def record(train_mode=True):
    """``with autograd.record():`` sets recording and (by default)
    training for its body."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training

