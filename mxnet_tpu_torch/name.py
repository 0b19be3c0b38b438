"""Automatic symbol naming (counterpart of `mxnet_tpu/name.py`):
``NameManager`` numbers nodes per hint; ``Prefix`` puts a Gluon block's
prefix before every name made inside its ``name_scope()``."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @staticmethod
    def current():
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        return NameManager._current.value


class Prefix(NameManager):
    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
