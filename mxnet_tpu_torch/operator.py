"""Python custom operators: ``mx.operator.CustomOp`` / ``CustomOpProp``.

Counterpart of `mxnet_tpu/operator.py` (reference
`python/mxnet/operator.py`): a user subclasses :class:`CustomOp` (forward
and backward over NDArrays), describes it with a :class:`CustomOpProp`,
registers the prop by name with :func:`register`, and calls it as
``mx.nd.Custom(..., op_type=name)`` or ``mx.sym.Custom(...)``, or inside a
Gluon block.

The op ``Custom`` runs the user's Python on the host, on NDArrays of the
op's context: eagerly, in a ``Module``'s executor, and in a hybridized
block. Under the tape (``autograd.record()`` or an executor's training
forward with an input that takes a gradient) it is a
``torch.autograd.Function`` whose backward calls ``CustomOp.backward``
with the head gradients; auxiliary inputs get no gradient. A prop made
with ``need_top_grad=False`` (a loss) takes no head gradient from its
caller: a backward from its output starts from ones, and the op's
backward may ignore ``out_grad``. The JAX package reaches the host from
inside a compiled program through ``jax.pure_callback``; a CUDA graph
cannot hold that round trip, so a hybridized program whose function calls
``Custom`` is not captured: it runs eagerly on every call, and
``compiled.compile_counts()["uncaptured"]`` counts it
(`compiled.py::note_host_op`). On ``meta`` tensors (the port's shape
inference) the op returns the shapes and types of the prop's
``infer_shape`` / ``infer_type`` without running the user's code.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import autograd
from . import compiled
from .base import MXNetError, numpy_dtype, torch_dtype
from .ndarray.ndarray import NDArray
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls"]

_PROPS = {}


class CustomOp(object):
    """Base class of a custom operator's computation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` (an NDArray, a tensor or anything numpy takes) to
        ``dst`` as ``req`` says: "write"/"inplace" replace, "add" adds,
        "null" does nothing."""
        if req == "null":
            return
        if isinstance(src, NDArray):
            src = src.data
        elif not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        src = src.to(device=dst.data.device, dtype=dst.data.dtype)
        if req in ("write", "inplace"):
            dst._data = src.clone() if src is dst.data else src.detach()
        elif req == "add":
            dst._data = dst.data + src
        else:
            raise ValueError("unknown req %r" % (req,))


class CustomOpProp(object):
    """A custom operator's properties: its arguments, outputs and
    auxiliary states, their shapes and types, and its operator."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a :class:`CustomOpProp` subclass under ``reg_name``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("%s must subclass CustomOpProp" % prop_cls)
        _PROPS[reg_name] = prop_cls
        _prop_from_ptuple.cache_clear()
        return prop_cls

    return deco


def get_prop_cls(name):
    try:
        return _PROPS[name]
    except KeyError:
        raise MXNetError("custom op %r is not registered" % name) from None


def _hashable(params):
    """The user's attributes (the framework's ``_`` keys dropped) as a
    sorted tuple; values that are not scalars become strings, as the
    reference passes every attribute as a string."""
    return tuple(sorted(
        (k, v if isinstance(v, (int, float, bool, str)) else str(v))
        for k, v in params.items() if not k.startswith("_")))


@functools.lru_cache(maxsize=256)
def _prop_from_ptuple(ptuple):
    d = dict(ptuple)
    op_type = d.pop("op_type", None)
    if not op_type:
        raise MXNetError("Custom op requires op_type=<registered name>")
    cls = get_prop_cls(op_type)
    try:
        return cls(**d)
    except TypeError:
        return cls(**{k: str(v) for k, v in d.items()})


def _custom_n_out(params):
    return len(_prop_from_ptuple(_hashable(params)).list_outputs())


def _out_specs(prop, inputs):
    """[(shape, torch dtype)] of the outputs, from the prop."""
    n_args = len(prop.list_arguments())
    out_shapes = prop.infer_shape([list(x.shape) for x in inputs[:n_args]])[1]
    dtypes = prop.infer_type([numpy_dtype(x.dtype)
                              for x in inputs[:n_args]])[1]
    return [(tuple(int(d) for d in s), torch_dtype(t))
            for s, t in zip(out_shapes, dtypes)]


def _operator(prop, ctx, inputs):
    n_args = len(prop.list_arguments())
    return prop.create_operator(ctx, [list(x.shape) for x in inputs[:n_args]],
                                [numpy_dtype(x.dtype)
                                 for x in inputs[:n_args]]), n_args


def _wrap(tensors, ctx):
    return [NDArray(t.detach(), ctx) for t in tensors]


def _run_forward(ptuple, is_train, ctx, inputs):
    prop = _prop_from_ptuple(ptuple)
    op, n_args = _operator(prop, ctx, inputs)
    dev = inputs[0].device if inputs else ctx.torch_device()
    out_data = [NDArray(torch.zeros(s, dtype=d, device=dev), ctx)
                for s, d in _out_specs(prop, inputs)]
    with torch.no_grad(), autograd.pause(train_mode=is_train):
        op.forward(is_train, ["write"] * len(out_data),
                   _wrap(inputs[:n_args], ctx), out_data,
                   _wrap(inputs[n_args:], ctx))
    return tuple(o.data.to(dev) for o in out_data)


class _CustomFunction(torch.autograd.Function):
    """``Custom`` on the tape: the forward and ``CustomOp.backward``."""

    @staticmethod
    def forward(fctx, ptuple, is_train, ctx, *inputs):
        outs = _run_forward(ptuple, is_train, ctx, inputs)
        fctx.save_for_backward(*inputs, *outs)
        fctx.custom = (ptuple, ctx, len(inputs))
        return outs

    @staticmethod
    def backward(fctx, *out_grads):
        ptuple, ctx, n_in = fctx.custom
        saved = fctx.saved_tensors
        inputs, outs = saved[:n_in], saved[n_in:]
        prop = _prop_from_ptuple(ptuple)
        op, n_args = _operator(prop, ctx, inputs)
        in_grad = [NDArray(torch.zeros_like(x), ctx)
                   for x in inputs[:n_args]]
        with torch.no_grad(), autograd.pause():
            op.backward(["write"] * n_args, _wrap(out_grads, ctx),
                        _wrap(inputs[:n_args], ctx), _wrap(outs, ctx),
                        in_grad, _wrap(inputs[n_args:], ctx))
        grads = [g.data.to(x.device) for g, x in zip(in_grad, inputs)]
        return (None, None, None) + tuple(grads) + \
            (None,) * (n_in - n_args)


@_register_op("Custom", num_outputs=_custom_n_out, need_train_flag=True)
def _custom(params, *inputs):
    """Dispatch to the registered CustomOpProp/CustomOp pair named by
    ``op_type`` (see the module docstring)."""
    ptuple = _hashable(params)
    prop = _prop_from_ptuple(ptuple)
    if any(x.device.type == "meta" for x in inputs):
        return tuple(torch.empty(s, dtype=d, device="meta")
                     for s, d in _out_specs(prop, inputs))
    compiled.note_host_op("Custom")
    is_train = bool(params.get("_is_train", False))
    ctx = params.get("_ctx")
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _CustomFunction.apply(ptuple, is_train, ctx, *inputs)
    return _run_forward(ptuple, is_train, ctx, inputs)


def _refresh_frontends():
    """``Custom`` is registered after ``nd`` and ``sym`` were generated;
    add it to both."""
    from . import ndarray as _ndpkg
    from . import symbol as _sympkg
    from .ndarray.register import populate as _npop
    from .symbol.register import populate as _spop
    _npop(vars(_ndpkg))
    _spop(vars(_sympkg))


_refresh_frontends()
