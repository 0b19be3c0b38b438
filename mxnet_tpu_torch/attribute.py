"""Symbol attribute scoping (counterpart of `mxnet_tpu/attribute.py`,
reference `python/mxnet/attribute.py`).

``with mx.AttrScope(ctx_group='dev1'):`` attaches string attributes to
every symbol made inside the scope (`symbol.create`, `symbol.var`): they
show in ``attr_dict()`` as in the JAX package. The port runs a graph on
one device, so ``ctx_group`` places nothing.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs

    def get(self, attr):
        """The scope's attributes updated with ``attr`` (a dict or
        None)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value
