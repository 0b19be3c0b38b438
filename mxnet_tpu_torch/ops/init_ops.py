"""Source operators: arrays made from attributes alone.

Counterpart of `mxnet_tpu/ops/init_ops.py` (reference
`src/operator/tensor/init_op.h`): ``zeros``, ``ones``, ``full``,
``arange`` (with ``repeat``), ``eye`` (with ``k`` and ``M``) and
``linspace`` (with ``endpoint``), each also under its ``_`` name, in f32
unless ``dtype`` says otherwise. An op takes no input, so it draws its
device from the call's context (``params["_ctx"]``); symbolic shape
inference gives none, and the op then returns a ``meta`` tensor.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

__all__ = []


def _shape(params):
    s = params.get("shape", ())
    return (s,) if isinstance(s, int) else tuple(s)


def _kw(params):
    """``dtype`` and ``device`` of the op's output."""
    ctx = params.get("_ctx")
    return {"dtype": torch_dtype(params.get("dtype") or "float32"),
            "device": ctx.torch_device() if ctx is not None else "meta"}


@register("_zeros", aliases=("zeros",))
def _zeros(params):
    return (torch.zeros(_shape(params), **_kw(params)),)


@register("_ones", aliases=("ones",))
def _ones(params):
    return (torch.ones(_shape(params), **_kw(params)),)


@register("_full", aliases=("full",))
def _full(params):
    return (torch.full(_shape(params), params["value"], **_kw(params)),)


@register("_arange", aliases=("arange",))
def _arange(params):
    start, stop = params.get("start", 0), params.get("stop")
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, params.get("step", 1.0), **_kw(params))
    rep = int(params.get("repeat", 1))
    if rep > 1:
        out = torch.repeat_interleave(out, rep)
    return (out,)


@register("_eye", aliases=("eye",))
def _eye(params):
    """1 where the column index minus the row index is ``k``."""
    kw = _kw(params)
    n = int(params["N"])
    m = int(params.get("M") or n)
    rows = torch.arange(n, device=kw["device"]).unsqueeze(1)
    cols = torch.arange(m, device=kw["device"]).unsqueeze(0)
    return ((cols - rows == int(params.get("k", 0))).to(kw["dtype"]),)


@register("_linspace", aliases=("linspace",))
def _linspace(params):
    num = int(params["num"])
    endpoint = params.get("endpoint", True)
    out = torch.linspace(float(params["start"]), float(params["stop"]),
                         num if endpoint else num + 1, **_kw(params))
    return (out if endpoint else out[:num],)
