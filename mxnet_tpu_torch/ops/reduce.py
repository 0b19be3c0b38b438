"""Reduction operators.

Counterpart of `mxnet_tpu/ops/reduce.py` (reference
`src/operator/tensor/broadcast_reduce_op.h`): ``sum``, ``mean``,
``prod``, ``nansum``, ``nanprod``, ``max``, ``min``, ``norm`` and
``square_sum`` with ``axis``, ``keepdims`` and ``exclude``, and
``L2Normalization``. No axis (or an empty tuple) reduces every axis;
with ``exclude`` the axes not named are reduced, so excluding every axis
reduces none and the op is the identity (a Gluon loss over a batch of
scalars). ``max`` and ``min`` split the gradient evenly among ties, as
``jnp.max`` does. An integer ``sum`` or ``prod`` keeps the input's dtype
and an integer ``mean`` is f32 (the JAX package, under x64, gives int64
and f64 with the same values).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _axes(x, params):
    """The axes to reduce, as a tuple (empty: none)."""
    axis = params.get("axis")
    if axis is None or axis == ():
        return tuple(range(x.dim()))
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    axis = tuple(a % x.dim() for a in axis) if x.dim() else ()
    if params.get("exclude"):
        axis = tuple(i for i in range(x.dim()) if i not in axis)
    return axis


def _reduce(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def _op(params, x):
        axes = _axes(x, params)
        if not axes:
            return (x,)
        return (fn(x, axes, bool(params.get("keepdims", False))),)
    return _op


def _sum(x, axes, keepdims):
    # an integer sum keeps the input's dtype, as jnp.sum does
    dtype = None if x.is_floating_point() else x.dtype
    return torch.sum(x, axes, keepdims, dtype=dtype)


def _mean(x, axes, keepdims):
    return torch.mean(x if x.is_floating_point() else x.float(), axes,
                      keepdims)


def _prod(x, axes, keepdims):
    dtype = None if x.is_floating_point() else x.dtype
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, a, keepdims, dtype=dtype)
    return x


_reduce("sum", _sum, aliases=("sum_axis",))
_reduce("mean", _mean)
_reduce("prod", _prod)
_reduce("nansum", torch.nansum)
_reduce("nanprod", lambda x, axes, keepdims: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), axes, keepdims))
_reduce("square_sum", lambda x, axes, keepdims: torch.sum(
    torch.square(x), axes, keepdims))
_reduce("max", torch.amax, aliases=("max_axis",))
_reduce("min", torch.amin, aliases=("min_axis",))


@register("norm")
def _norm(params, x):
    """The L1 or L2 norm over the axes (``ord`` 1 or 2)."""
    axes = _axes(x, params)
    keepdims = bool(params.get("keepdims", False))
    if int(params.get("ord", 2)) == 1:
        a = torch.abs(x)
        return (torch.sum(a, axes, keepdims) if axes else a,)
    sq = torch.square(x)
    return (torch.sqrt(torch.sum(sq, axes, keepdims) if axes else sq),)


@register("L2Normalization")
def _l2_normalization(params, x):
    """Reference `src/operator/l2_normalization-inl.h`: ``x`` over the
    L2 norm (plus ``eps`` under the root) of each instance (every axis
    after the first), channel (axis 1) or spatial position (the axes
    after the second)."""
    eps = float(params.get("eps", 1e-10))
    mode = params.get("mode", "instance")
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, x.dim()))
    return (x / torch.sqrt(torch.sum(torch.square(x), axes, True) + eps),)
