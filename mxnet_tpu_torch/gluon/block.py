"""Gluon Block and HybridBlock.

Counterpart of `mxnet_tpu/gluon/block.py` (reference
`python/mxnet/gluon/block.py:123,486`): blocks with prefixed name scopes,
child registration, ``collect_params`` and ``initialize``; an eager
forward through ``hybrid_forward(F=nd, ...)`` that finishes deferred
parameter shapes on the first call (a leaf layer implements
``_infer_shapes``); and ``_trace_symbol``, which runs ``hybrid_forward``
with ``F=sym`` and the parameters' variables to build the Symbol that
``Module`` binds. The JAX package's compiled ``hybridize`` (one jitted
program per signature) is not ported yet: ``hybridize()`` records the
flag, says so once, and the forward stays eager. ``SymbolBlock``,
forward hooks, ``summary`` and parameter files wait too.
"""
from __future__ import annotations

import re
import threading
import warnings
from collections import OrderedDict

from .. import ndarray as nd_mod
from .. import symbol as sym_mod
from ..name import NameManager, Prefix
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """The name scope of a block: children made inside it are prefixed
    with the block's prefix and numbered per kind."""
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current().get(None, hint) + "_"
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block:
    """Reference gluon/block.py:123 Block."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params:
                raise TypeError("Overriding Parameter attribute %s is not "
                                "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """This block's and every descendant's parameters, optionally
        those whose name matches the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        ret.update({name: value for name, value in self.params.items()
                    if pattern is None or pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on ``ctx`` (gpu(0) by default); a
        parameter with unknown dimensions waits for the first forward."""
        from ..initializer import Uniform
        self.collect_params().initialize(init or Uniform(), ctx, verbose,
                                         force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Reference gluon/block.py:486; the forward runs eagerly (see the
    module docstring) or, given a Symbol, builds the graph."""

    _told = False       # hybridize's message is given once per process

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError("Children of HybridBlock must also be "
                             "HybridBlock, but %s has type %s."
                             % (block, type(block)))
        super().register_child(block, name)

    def hybridize(self, active=True, **kwargs):
        """Record the flag. The compiled call is not ported: the forward
        stays eager, and this says so once."""
        self._active = active
        if active and not HybridBlock._told:
            HybridBlock._told = True
            warnings.warn("hybridize(): the port has no compiled Gluon call "
                          "yet; the block runs eagerly", stacklevel=2)
        super().hybridize(active, **kwargs)

    def _forward_impl(self, *args):
        """Eager forward through ``hybrid_forward`` with the parameters
        injected; Symbol inputs go to the symbolic tracer. Deferred
        parameters learn their shapes from the first input
        (``_infer_shapes``) and are initialised here."""
        if args and isinstance(args[0], sym_mod.Symbol):
            return self._symbolic_forward(*args)
        if any(p._deferred_init for p in self._reg_params.values()):
            self._infer_shapes(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
        params = {k: v.data() for k, v in self._reg_params.items()}
        return self.hybrid_forward(nd_mod, *args, **params)

    def _infer_shapes(self, *args):
        """Leaf layers fill their deferred parameter shapes from the
        input here."""

    def forward(self, x, *args):
        return self._forward_impl(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _trace_symbol(self):
        """The block's graph over a ``data`` variable."""
        out = self._symbolic_forward(sym_mod.var("data"))
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        return out

    def _symbolic_forward(self, *args):
        """``hybrid_forward`` with the symbol namespace and the
        parameters' variables; children called inside it come back here
        through ``_forward_impl``."""
        params = {k: v.var() for k, v in self._reg_params.items()}
        return self.hybrid_forward(sym_mod, *args, **params)
