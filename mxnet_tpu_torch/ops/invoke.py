"""Eager operator dispatch.

Counterpart of `mxnet_tpu/ops/invoke.py` (reference
`Imperative::Invoke`): run one registered op over NDArrays, with the
train flag from `autograd.py` for the ops that read one, and write the
new values of ``mutate_aux`` inputs (BatchNorm's moving statistics) back
into those NDArrays in place. The autograd tape is not ported yet, so an
op runs without recording a gradient.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import random as _random
from ..context import current_context
from .registry import get_op

__all__ = ["invoke"]


def invoke(op_name, inputs, params=None, ctx=None):
    """Run an op eagerly over NDArray inputs; returns an NDArray, or a
    list of them for an op with several outputs."""
    from ..ndarray.ndarray import NDArray

    op = get_op(op_name)
    params = dict(params or {})
    in_arrs = list(inputs)
    if ctx is None:
        ctx = in_arrs[0].context if in_arrs else current_context()
    params.setdefault("_ctx", ctx)
    if op.need_train_flag:
        params.setdefault("_is_train", autograd.is_training())
    if op.need_rng and "_generator" not in params:
        gen = torch.Generator(device=ctx.torch_device())
        gen.manual_seed(_random.executor_seed())
        params["_generator"] = gen
    with torch.no_grad():
        outs = tuple(op.fcompute(params, *[a.data for a in in_arrs]))
        n_out = op.n_out(params)
        for idx, new in zip(op.mutate_aux, outs[n_out:]):
            dst = in_arrs[idx].data
            if new is not dst:
                dst.copy_(new)
    out_arrs = [NDArray(v, ctx) for v in outs[:n_out]]
    return out_arrs[0] if len(out_arrs) == 1 else out_arrs
