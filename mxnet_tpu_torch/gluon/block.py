"""Gluon Block and HybridBlock.

Counterpart of `mxnet_tpu/gluon/block.py` (reference
`python/mxnet/gluon/block.py:123,486`): blocks with prefixed name scopes,
child registration, ``collect_params``, ``initialize`` and ``cast``; an
eager forward through ``hybrid_forward(F=nd, ...)`` that finishes
deferred parameter shapes on the first call (a leaf layer implements
``_infer_shapes``); ``_trace_symbol``, which runs ``hybrid_forward``
with ``F=sym`` and the parameters' variables to build the Symbol that
``Module`` binds; and the compiled ``hybridize``.

A hybridized block calls one `compiled.CompiledProgram` (site
``gluon.hybrid_forward``) over ``traced(param_vals, key, is_train,
*inputs)``: on a CUDA device one captured CUDA graph per input
signature, replayed with the parameters read in place, so BatchNorm's
moving statistics step inside the graph; on the CPU the same cache and
counters over an eager run. The program is built on the first call and
dropped by ``hybridize``, ``register_child``, ``cast`` and setting a
child block as an attribute.

Under ``autograd.record()`` a hybridized call is differentiable with
respect to the parameters and the NDArray inputs, as the JAX package's
``jax.vjp`` over its program makes it: the recorded signature (recording
is part of every key, `compiled.py`) runs the program's function eagerly
with the tape on, and BatchNorm's moving statistics, off the tape, step
once. ``hybridize(remat=True)``, or ``MXNET_BACKWARD_DO_MIRROR=1``,
recomputes the activations in the backward pass instead of keeping them
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``): the
recompute runs with the aux write-back suppressed, so BatchNorm steps
once, and from the call's random key, so it draws the same bits.
Parameter files: ``save_parameters`` writes each parameter under its
structural name (``features.0.weight``, the attribute path from this
block), ``load_parameters`` reads that form or the prefixed names of
``save_params`` (the legacy form), in either package's ``.params``
container. Forward hooks (``register_forward_pre_hook``,
``register_forward_hook``) run around ``forward`` in ``Block.__call__``,
so a hybridized call fires them too; ``apply`` and ``summary`` walk the
children. ``export`` writes ``_trace_symbol()`` as ``<path>-symbol.json``
and every parameter, the moving statistics included, as ``arg:<name>``
in ``<path>-%04d.params``. ``SymbolBlock`` runs a Symbol (``imports``
reads ``export``'s pair) as an inference forward: one bound
`executor.Executor` a signature (input shapes, dtypes, context), which
reads the parameters' current tensors, so on the card each signature is
one captured CUDA graph and a call one ``cudaGraphLaunch``. As in the JAX
package it runs ``is_train=False`` and is not differentiable.
"""
from __future__ import annotations

import contextlib
import os
import re
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from .. import compiled as compiled_mod
from .. import ndarray as nd_mod
from .. import random as _random
from .. import symbol as sym_mod
from ..base import MXNetError
from ..context import cpu, gpu
from ..name import NameManager, Prefix
from ..ndarray.ndarray import NDArray
from ..ops.invoke import suppress_aux_writeback
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


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
        self._forward_hooks = OrderedDict()
        self._forward_pre_hooks = OrderedDict()

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

    # -- parameter files -------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: Parameter}``: the attribute path from this
        block, dot-separated (``features.0.weight``)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Write every parameter under its structural name."""
        from ..ndarray.utils import save as nd_save
        nd_save(filename, {k: v.data() for k, v in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a file of ``save_parameters`` (structural names), or of
        ``save_params`` (prefixed names, read through
        ``collect_params().load``). Parameters not yet initialised take
        the loaded values on ``ctx`` (see `parameter.py`)."""
        from ..ndarray.utils import load as nd_load
        loaded = nd_load(filename, ctx=cpu())      # read on the host
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in k for k in loaded):
            del loaded
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError("Parameter '%s' is missing in file '%s'"
                                     % (name, filename))
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise ValueError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in this block" % (name, filename))
                continue
            params[name]._load_init(value, ctx)

    def save_params(self, filename):
        """The legacy form: every parameter under its prefixed name with
        this block's prefix stripped."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Read a file of ``save_params``."""
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    # -- hooks and inspection --------------------------------------------
    def register_forward_pre_hook(self, hook):
        """Call ``hook(block, inputs)`` before each forward."""
        handle = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_hook(self, hook):
        """Call ``hook(block, inputs, outputs)`` after each forward."""
        handle = _HookHandle(self._forward_hooks)
        self._forward_hooks[handle.id] = hook
        return handle

    def apply(self, fn):
        """``fn(block)`` on every child, recursively, then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on ``ctx`` (by default the enclosing
        ``with ctx:`` scope's, else gpu(0)); a parameter with unknown
        dimensions waits for the first forward."""
        from ..initializer import Uniform
        self.collect_params().initialize(init or Uniform(), ctx, verbose,
                                         force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        ``dtype``."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Run ``inputs`` through the block and print, for each block
        called, its output shapes and parameter counts (the JAX package's
        table, line for line)."""
        summary = OrderedDict()
        hooks = []

        def shape_str(args):
            def flatten(args):
                if not isinstance(args, (list, tuple)):
                    return [args]
                return [x for a in args for x in flatten(a)]
            return str([x.shape if isinstance(x, NDArray) else None
                        for x in flatten(args)])

        def register(block):
            def hook(block, inputs, outputs):
                key = "%s-%i" % (block.__class__.__name__, len(summary))
                row = summary[key] = OrderedDict()
                row["output_shape"] = shape_str(outputs)
                params = trainable = 0
                for p in block.params.values():
                    size = int(np.prod(p.shape)) if p.shape else 0
                    params += size
                    trainable += 0 if p.grad_req == "null" else size
                row["trainable"] = trainable
                row["n_params"] = params
            hooks.append(block.register_forward_hook(hook))

        try:
            self.apply(register)
            self(*inputs)
            line_format = "{:>20}  {:>42} {:>15}"
            print("-" * 80)
            print(line_format.format("Layer (type)", "Output Shape",
                                     "Param #"))
            print("=" * 80)
            total_params = trainable_params = 0
            for layer, row in summary.items():
                print(line_format.format(layer, str(row["output_shape"]),
                                         row["n_params"]))
                total_params += row["n_params"]
                trainable_params += row["trainable"]
            print("=" * 80)
            print("Total params: " + str(total_params))
            print("Trainable params: " + str(trainable_params))
            print("-" * 80)
        finally:
            for h in hooks:
                h.detach()


class _HookHandle:
    """Detaches one hook from its block."""
    _counter = [0]

    def __init__(self, hooks_dict):
        _HookHandle._counter[0] += 1
        self.id = _HookHandle._counter[0]
        self._hooks_dict = hooks_dict

    def detach(self):
        self._hooks_dict.pop(self.id, None)


def _remat_contexts():
    """``torch.utils.checkpoint``'s contexts: the forward as it is; the
    recompute with BatchNorm's moving-statistics write-back suppressed,
    since the forward already stepped them."""
    return contextlib.nullcontext(), suppress_aux_writeback()


def _remat(traced):
    """``traced`` keeping no activations of a recorded call: a checkpoint
    whose backward runs it again (recording, inline and from the same
    random key, so the recompute matches the forward). An unrecorded call
    runs ``traced`` as it is."""
    from torch.utils.checkpoint import checkpoint

    def again(param_vals, key, is_train, *inputs):
        with autograd.record(train_mode=is_train), \
                compiled_mod.inline("gluon.remat"):
            return traced(param_vals, key, is_train, *inputs)

    def remat(param_vals, key, is_train, *inputs):
        if not autograd.is_recording():
            return traced(param_vals, key, is_train, *inputs)
        return checkpoint(again, param_vals, key, is_train, *inputs,
                          use_reentrant=False, context_fn=_remat_contexts)
    return remat


def _context_of(tensor):
    device = tensor.device
    return cpu() if device.type == "cpu" else gpu(device.index or 0)


def _unwrap(obj):
    """``obj`` with the NDArrays of its lists and tuples (a recurrent
    cell's states) replaced by their tensors."""
    if isinstance(obj, NDArray):
        return obj.data
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unwrap(v) for v in obj)
    return obj


def _wrap(obj, ctx=None):
    """The inverse of :func:`_unwrap`: tensors as NDArrays on ``ctx``,
    else on their own device."""
    if isinstance(obj, torch.Tensor):
        return NDArray(obj, ctx or _context_of(obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_wrap(v, ctx) for v in obj)
    return obj


class HybridBlock(Block):
    """Reference gluon/block.py:486: the forward runs eagerly, given a
    Symbol builds the graph, and after ``hybridize()`` runs as one
    compiled program (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._cached_jit = None
        self._param_order = None
        self._param_objs = None
        # the lineage of this block's programs: a token of its own, since
        # the id() of a collected block is reused by later objects
        self._lineage = object()

    def infer_shape(self, *args):
        """Nothing, as in the JAX package: deferred shapes are filled by
        the first forward (each leaf layer's ``_infer_shapes``)."""

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError("Children of HybridBlock must also be "
                             "HybridBlock, but %s has type %s."
                             % (block, type(block)))
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        """Run this block and its children as one compiled program from
        the next call (``active=False``: eagerly again). ``remat=True``
        (the default under ``MXNET_BACKWARD_DO_MIRROR=1``) recomputes the
        activations of a recorded call in its backward pass."""
        if "remat" not in kwargs and \
                os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") == "1":
            kwargs["remat"] = True
        self._active = active
        self._flags = kwargs
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_jit = None
        self._param_order = None
        self._param_objs = None

    def _build_jit(self):
        """One `CompiledProgram` over ``traced(param_vals, key, is_train,
        *inputs) -> (outs, aux_up)``: the parameters in sorted name order
        (read in place), ``key`` the call's random seed and ``is_train``
        static. ``aux_up`` is empty: the moving statistics are written in
        place, by the graph itself on CUDA. With ``remat`` a recorded call
        runs ``traced`` under a checkpoint (:func:`_remat`)."""
        params = self.collect_params()
        names = sorted(params.keys())
        objs = [params[n] for n in names]
        self._param_order = names
        self._param_objs = objs
        block = self

        def traced(param_vals, key, is_train, *inputs):
            saved = [p._data for p in objs]
            try:
                for p, v in zip(objs, param_vals):
                    p._data = NDArray(v, _context_of(v))
                with _random.key_scope(key), (autograd.train_mode()
                                              if is_train
                                              else autograd.predict_mode()):
                    out = block._forward_impl(*_wrap(inputs))
            finally:
                for p, d in zip(objs, saved):
                    p._data = d
            if isinstance(out, (list, tuple)):
                return _unwrap(tuple(out)), {}
            return (out.data,), {}

        if self._flags.get("remat") or \
                self._flags.get("static_alloc") == "remat":
            traced = _remat(traced)
        # lineage: this block, so its rebuilt programs diff against each
        # other and unrelated nets never do
        self._cached_jit = compiled_mod.CompiledProgram(
            traced, "gluon.hybrid_forward", static_argnums=(2,),
            inplace_argnums=(0,), key_argnums=(1,), lineage=self._lineage,
            arg_names={0: names})

    def _call_cached(self, *args):
        if self._cached_jit is None:
            self._build_jit()
        param_vals = [p.data().data for p in self._param_objs]
        ctx = args[0].context if args and isinstance(args[0], NDArray) \
            else None
        outs, _ = self._cached_jit(param_vals, _random.executor_seed(ctx),
                                   autograd.is_training(), *_unwrap(args))
        out_nds = _wrap(outs, ctx)
        return out_nds[0] if len(out_nds) == 1 else tuple(out_nds)

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
        if self._active and compiled_mod.running() is None \
                and not isinstance(x, sym_mod.Symbol):
            try:
                return self._call_cached(x, *args)
            except DeferredInitializationError:
                # one eager pass materialises the deferred parameters; its
                # moving-statistics step is suppressed, since the compiled
                # call that follows performs it, hybridized children
                # called inside it run inline, and it records nothing
                self._clear_cached_op()
                with suppress_aux_writeback(), \
                        compiled_mod.inline("gluon.deferred_init"), \
                        autograd.pause(train_mode=autograd.is_training()):
                    self._forward_impl(x, *args)
                return self._call_cached(x, *args)
        return self._forward_impl(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``<path>-symbol.json`` (``_trace_symbol()``) and
        ``<path>-%04d.params``: every parameter, the moving statistics
        too, as ``arg:<name>``, as the JAX package writes them."""
        from ..ndarray.utils import save as nd_save
        self._trace_symbol().save("%s-symbol.json" % path)
        nd_save("%s-%04d.params" % (path, epoch),
                {"arg:%s" % name: param.data()
                 for name, param in self.collect_params().items()})

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


class SymbolBlock(HybridBlock):
    """A Block over a Symbol (reference ``gluon.SymbolBlock``): the
    symbol's free variables other than ``inputs`` are its parameters,
    named exactly as in the symbol (no prefix); auxiliary states take no
    gradient. ``params`` shares parameters with another block. The
    forward is an inference forward (``is_train=False``), not
    differentiable, through one bound executor a signature (see the
    module docstring)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        self._aux_names = set(outputs.list_auxiliary_states())
        self._executors = {}
        for name in outputs.list_inputs():
            if name in self._input_names:
                continue
            if self.params._get_impl(name) is None:
                self.params._params[name] = Parameter(
                    name, allow_deferred_init=True,
                    grad_req="null" if name in self._aux_names else "write")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over ``symbol_file`` (``export``'s JSON) with
        ``input_names`` as inputs and, when given, the values of
        ``param_file`` (``arg:``/``aux:`` tags dropped) on ``ctx``."""
        from ..ndarray.utils import load as nd_load
        sym = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [sym_mod.var(i) for i in input_names])
        if param_file is not None:
            for key, value in nd_load(param_file, ctx=cpu()).items():
                name = key.split(":", 1)[-1]
                if name in ret.params.keys():
                    ret.params[name]._load_init(value, ctx)
        return ret

    def _clear_cached_op(self):
        super()._clear_cached_op()
        self._executors = {}

    def forward(self, x, *args):
        from ..executor import Executor
        inputs = (x,) + args
        ctx = x.context
        key = (ctx,) + tuple((tuple(a.shape), a.data.dtype) for a in inputs)
        exe = self._executors.get(key)
        if exe is None:
            args_d = {name: NDArray(torch.empty_like(a.data), ctx)
                      for name, a in zip(self._input_names, inputs)}
            aux_d = {}
            for name, p in self.params.items():
                (aux_d if name in self._aux_names else args_d)[name] = \
                    p.data()
            exe = self._executors[key] = Executor.bind(
                self._symbol, ctx, args_d, aux_states=aux_d)
        for name, p in self.params.items():
            # the parameters' current tensors (a cast or reset_ctx makes
            # new ones); in place, a changed one is one recapture
            (exe.aux_dict if name in self._aux_names else exe.arg_dict)[
                name] = p.data()
        outs = exe.forward(is_train=False, **dict(zip(self._input_names,
                                                      inputs)))
        return outs[0] if len(outs) == 1 else outs

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
