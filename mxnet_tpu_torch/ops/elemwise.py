"""Elementwise binary and scalar operators (the subset the port's graphs use).

Counterpart of `mxnet_tpu/ops/elemwise.py`: the ``broadcast_*`` family of
the four arithmetic operators with their ``elemwise_*`` and ``_plus``-style
aliases, the scalar family that NDArray and Symbol arithmetic reach, and
``negative``. A scalar keeps the array's dtype, as in the reference.
"""
from __future__ import annotations

import torch

from .registry import register


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


_binary("broadcast_add", torch.add,
        aliases=("broadcast_plus", "elemwise_add", "_add", "_plus"))
_binary("broadcast_sub", torch.sub,
        aliases=("broadcast_minus", "elemwise_sub", "_sub", "_minus"))
_binary("broadcast_mul", torch.mul, aliases=("elemwise_mul", "_mul"))
_binary("broadcast_div", torch.div, aliases=("elemwise_div", "_div"))

_scalar("_plus_scalar", torch.add)
_scalar("_minus_scalar", torch.sub)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", torch.mul)
_scalar("_div_scalar", torch.div)
_scalar("_rdiv_scalar", lambda x, s: s / x)


@register("negative")
def _negative(params, x):
    return (torch.neg(x),)
