"""Reduction operators.

Counterpart of `mxnet_tpu/ops/reduce.py` (reference
`src/operator/tensor/broadcast_reduce_op.h`): ``sum``, ``mean``, ``max``,
``min`` and ``norm`` with ``axis``, ``keepdims`` and ``exclude``. No
axis (or an empty tuple) reduces every axis; with ``exclude`` the axes
not named are reduced, so excluding every axis reduces none and the op
is the identity (a Gluon loss over a batch of scalars). ``max`` and
``min`` split the gradient evenly among ties, as ``jnp.max`` does.
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


_reduce("sum", _sum, aliases=("sum_axis",))
_reduce("mean", torch.mean)
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
