"""Elementwise operators (the subset the port's graphs, losses and Gluon
utilities use).

Counterpart of `mxnet_tpu/ops/elemwise.py`: the unary math the losses
reach (``abs``, ``square``, ``sqrt``, ``exp``, ``log``, ``relu``,
``sigmoid``), ``Cast`` and ``where``; the
``broadcast_*`` family of the four arithmetic operators with their
``elemwise_*`` and ``_plus``-style aliases, ``maximum``/``minimum`` and
the orderings (``greater``, ``lesser`` and their ``_equal`` forms: 1
where true, 0 elsewhere, in the left operand's dtype); the scalar forms of all of these that NDArray and Symbol
arithmetic reach; and ``negative``. A scalar keeps the array's dtype,
as in the reference. Every op is differentiable through torch's autograd
where the JAX package's is through ``jax.vjp`` (a comparison has no
gradient; ``maximum`` splits a tie evenly, as ``jnp.maximum`` does).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _unary(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def _op(params, x):
        return (fn(x),)
    return _op


def _binary(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def _op(params, lhs, rhs):
        return (fn(lhs, rhs),)
    return _op


def _scalar(name, fn):
    @register(name)
    def _op(params, x):
        return (fn(x, float(params["scalar"])),)
    return _op


def _as_tensor(x, s):
    """The scalar ``s`` as a 0-d tensor of ``x``'s dtype and device."""
    return x.new_full((), s)


def _compare(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


_unary("abs", torch.abs)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("negative", torch.neg)


@register("Cast", aliases=("cast",))
def _cast(params, x):
    return (x.to(torch_dtype(params["dtype"])),)


@register("where")
def _where(params, cond, x, y):
    """``x`` where ``cond`` is non-zero, else ``y``; a ``cond`` of lower
    rank lines up with the leading axes."""
    c = cond if cond.dim() == x.dim() else cond.reshape(
        tuple(cond.shape) + (1,) * (x.dim() - cond.dim()))
    return (torch.where(c != 0, x, y),)


_binary("broadcast_add", torch.add,
        aliases=("broadcast_plus", "elemwise_add", "_add", "_plus"))
_binary("broadcast_sub", torch.sub,
        aliases=("broadcast_minus", "elemwise_sub", "_sub", "_minus"))
_binary("broadcast_mul", torch.mul, aliases=("elemwise_mul", "_mul"))
_binary("broadcast_div", torch.div, aliases=("elemwise_div", "_div"))
_binary("broadcast_maximum", torch.maximum, aliases=("_maximum", "maximum"))
_binary("broadcast_minimum", torch.minimum, aliases=("_minimum", "minimum"))
for _name, _fn in (("greater", torch.gt), ("greater_equal", torch.ge),
                   ("lesser", torch.lt), ("lesser_equal", torch.le)):
    _binary("broadcast_" + _name, _compare(_fn), aliases=("_" + _name,))
    _scalar("_%s_scalar" % _name, _compare(_fn))

_scalar("_plus_scalar", torch.add)
_scalar("_minus_scalar", torch.sub)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", torch.mul)
_scalar("_div_scalar", torch.div)
_scalar("_rdiv_scalar", lambda x, s: s / x)
_scalar("_maximum_scalar", lambda x, s: torch.maximum(x, _as_tensor(x, s)))
_scalar("_minimum_scalar", lambda x, s: torch.minimum(x, _as_tensor(x, s)))
