"""Contrib nn blocks (counterpart of `mxnet_tpu/gluon/contrib/nn.py`,
reference python/mxnet/gluon/contrib/nn/basic_layers.py): ``Concurrent``
and ``HybridConcurrent`` run their children on the same input and
concatenate the outputs along ``axis``; ``Identity``."""
from __future__ import annotations

from ..block import Block, HybridBlock

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class Concurrent(Block):
    """Imperative parallel branches (reference basic_layers.py:27)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        from ... import ndarray as F
        outs = [block(x) for block in self._children.values()]
        return F.concat(*outs, dim=self.axis)


class HybridConcurrent(HybridBlock):
    """Parallel hybrid branches: eager, traced to a Symbol, or inside the
    compiled program of a hybridized parent."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        raise RuntimeError("HybridConcurrent dispatches via _forward_impl")

    def _forward_impl(self, x):
        from ... import symbol as sym_mod
        if isinstance(x, sym_mod.Symbol):
            return self._symbolic_forward(x)
        from ... import ndarray as F
        outs = [c._forward_impl(x) for c in self._children.values()]
        return F.Concat(*outs, dim=self.axis)

    def _symbolic_forward(self, x):
        from ... import symbol as F
        outs = [c._symbolic_forward(x) for c in self._children.values()]
        return F.Concat(*outs, dim=self.axis)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x
