"""Elementwise operators.

Counterpart of `mxnet_tpu/ops/elemwise.py` (reference
`src/operator/tensor/elemwise_*`, `src/operator/mshadow_op.h`), with the
same names and aliases: the unary math (rounding, roots, the log/exp,
trigonometric and hyperbolic families, ``erf``/``erfinv``,
``gamma``/``gammaln``, ``sign``, ``softsign``, ``reciprocal``),
``Cast``, ``clip``, ``smooth_l1`` and ``where``; the ``broadcast_*``
family (the four arithmetic operators with their ``elemwise_*`` and
``_plus``-style aliases, ``mod``, ``power``, ``hypot``,
``maximum``/``minimum``, the orderings and ``equal``/``not_equal``, which
give 1 where true and 0 elsewhere in the left operand's dtype, and the
``logical_*`` ops), ``arctan2`` and ``ldexp``; the scalar forms of all of
these that NDArray and Symbol arithmetic reach; ``zeros_like``,
``ones_like``, ``_copy``/``identity`` (a copy: the port's arrays are
mutable), ``add_n``, ``BlockGrad`` (no gradient flows back through it)
and ``make_loss`` (the identity). A scalar is rounded to the array's
dtype first, so an integer array stays integer (``a + 1.5`` adds 1), as
the JAX package's ``_promote_scalar`` does. Every op is differentiable
through torch's autograd where the JAX package's is through ``jax.vjp``
(a comparison has no gradient; ``maximum`` splits a tie evenly, as
``jnp.maximum`` does).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _scalar_value(x, s):
    """``s`` rounded to ``x``'s dtype, as a Python number (int32 keeps
    1 of 1.5, bf16 its nearest bf16 value)."""
    return torch.tensor(float(s), dtype=torch.float64).to(x.dtype).item()


def _scalar(name, fn):
    @register(name)
    def _op(params, x):
        return (fn(x, _scalar_value(x, params["scalar"])),)
    return _op


def _as_tensor(x, s):
    """The scalar ``s`` as a 0-d tensor of ``x``'s dtype and device."""
    return x.new_full((), s)


def _compare(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


def _logical(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("rint", torch.round)
_unary("round", torch.round)       # half to even, as jnp.round
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", F.softsign)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("negative", torch.neg, aliases=("_np_negative",))
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("logical_not", lambda x: (x == 0).to(x.dtype))
_unary("_copy", torch.clone, aliases=("identity",))
_unary("zeros_like", torch.zeros_like)
_unary("ones_like", torch.ones_like)
_unary("BlockGrad", torch.Tensor.detach, aliases=("stop_gradient",))
_unary("make_loss", lambda x: x, aliases=("MakeLoss",))


@register("Cast", aliases=("cast",))
def _cast(params, x):
    return (x.to(torch_dtype(params["dtype"])),)


@register("clip")
def _clip(params, x):
    return (torch.clamp(x, params["a_min"], params["a_max"]),)


@register("smooth_l1")
def _smooth_l1(params, x):
    """Reference `src/operator/tensor/elemwise_unary_op.cc` smooth_l1:
    0.5 (s x)^2 inside |x| < 1/s^2, |x| - 0.5/s^2 outside."""
    s2 = float(params.get("scalar", 1.0)) ** 2
    absx = torch.abs(x)
    return (torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2),)


@register("where")
def _where(params, cond, x, y):
    """``x`` where ``cond`` is non-zero, else ``y``; a ``cond`` of lower
    rank lines up with the leading axes."""
    c = cond if cond.dim() == x.dim() else cond.reshape(
        tuple(cond.shape) + (1,) * (x.dim() - cond.dim()))
    return (torch.where(c != 0, x, y),)


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def _add_n(params, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return (out,)


_binary("broadcast_add", torch.add,
        aliases=("broadcast_plus", "elemwise_add", "_add", "_plus"))
_binary("broadcast_sub", torch.sub,
        aliases=("broadcast_minus", "elemwise_sub", "_sub", "_minus"))
_binary("broadcast_mul", torch.mul, aliases=("elemwise_mul", "_mul"))
_binary("broadcast_div", torch.div, aliases=("elemwise_div", "_div"))
_binary("broadcast_mod", torch.remainder, aliases=("_mod",))
_binary("broadcast_power", torch.pow, aliases=("_power", "pow"))
_binary("broadcast_maximum", torch.maximum, aliases=("_maximum", "maximum"))
_binary("broadcast_minimum", torch.minimum, aliases=("_minimum", "minimum"))
_binary("broadcast_hypot", torch.hypot, aliases=("_hypot",))
_binary("arctan2", torch.atan2, aliases=("_arctan2",))
_binary("ldexp", lambda a, b: a * torch.pow(2.0, b), aliases=("_ldexp",))
for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("greater", torch.gt), ("greater_equal", torch.ge),
                   ("lesser", torch.lt), ("lesser_equal", torch.le)):
    _binary("broadcast_" + _name, _compare(_fn), aliases=("_" + _name,))
    _scalar("_%s_scalar" % _name, _compare(_fn))
for _name, _fn in (("and", torch.logical_and), ("or", torch.logical_or),
                   ("xor", torch.logical_xor)):
    _binary("broadcast_logical_" + _name, _logical(_fn))
_scalar("_logical_and_scalar",
        lambda x, s: ((x != 0) & bool(s != 0)).to(x.dtype))
_scalar("_logical_or_scalar",
        lambda x, s: ((x != 0) | bool(s != 0)).to(x.dtype))

_scalar("_plus_scalar", torch.add)
_scalar("_scatter_plus_scalar", torch.add)
_scalar("_minus_scalar", torch.sub)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", torch.mul)
_scalar("_div_scalar", torch.div)
_scalar("_rdiv_scalar", lambda x, s: s / x)
_scalar("_mod_scalar", torch.remainder)
_scalar("_rmod_scalar", lambda x, s: torch.remainder(_as_tensor(x, s), x))
_scalar("_power_scalar", torch.pow)
_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar("_hypot_scalar", lambda x, s: torch.hypot(x, _as_tensor(x, s)))
_scalar("_maximum_scalar", lambda x, s: torch.maximum(x, _as_tensor(x, s)))
_scalar("_minimum_scalar", lambda x, s: torch.minimum(x, _as_tensor(x, s)))
