"""Eager operator dispatch.

Counterpart of `mxnet_tpu/ops/invoke.py` (reference
`Imperative::Invoke`): run one registered op over NDArrays, with the
train flag from `autograd.py` for the ops that read one, and write the
new values of ``mutate_aux`` inputs (BatchNorm's moving statistics) back
into those NDArrays in place, unless :func:`suppress_aux_writeback` is
in force. An op that draws random numbers gets a ``torch.Generator`` on
the op's device, seeded from `random.py`'s sequence (or, inside a
hybridized call, from the call's key); inside a CUDA graph capture it
raises, since every replay would draw the same bits. An op that draws
only in some modes (``Dropout`` outside training) gets no generator when
it does not draw.

With ``out=`` the outputs are copied into the given NDArrays (cast to
their dtype), which are returned; an output on the tape rebinds its
``out`` instead, as the JAX package rebinds it.

Under ``autograd.record()`` an op with an input that requires a gradient
runs with torch's grad mode on, so its outputs carry a ``grad_fn``: that
is the tape (the JAX package captures a ``jax.vjp`` here). Every other
op runs under ``torch.no_grad()``. The ``mutate_aux`` write-back stays
off the tape: the new values are detached and copied under
``torch.no_grad()``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..context import current_context
from .registry import get_op

__all__ = ["invoke", "suppress_aux_writeback"]

_TLS = threading.local()


@contextlib.contextmanager
def suppress_aux_writeback(suppress=True):
    """Run ops without committing their ``mutate_aux`` updates (BatchNorm's
    moving statistics), or, with ``suppress=False``, with them whatever
    an enclosing scope says. A hybridized block's eager passes before a
    compiled call use it: the compiled call performs the same update, and
    a double step would diverge from the eager trajectory."""
    prev = getattr(_TLS, "no_aux", False)
    _TLS.no_aux = suppress
    try:
        yield
    finally:
        _TLS.no_aux = prev


def invoke(op_name, inputs, params=None, ctx=None, out=None):
    """Run an op eagerly over NDArray inputs; returns an NDArray, or a
    list of them for an op with several outputs (``out`` when given)."""
    from ..ndarray.ndarray import NDArray

    op = get_op(op_name)
    params = dict(params or {})
    in_arrs = list(inputs)
    if ctx is None:
        ctx = in_arrs[0].context if in_arrs else current_context()
    params.setdefault("_ctx", ctx)
    if op.need_train_flag:
        params.setdefault("_is_train", autograd.is_training())
    if op.need_rng and "_generator" not in params and op.draws(params):
        if torch.cuda.is_initialized() and \
                torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                "op %s draws random numbers, and a captured CUDA graph "
                "would replay the same bits on every call" % op_name)
        gen = torch.Generator(device=ctx.torch_device())
        gen.manual_seed(_random.op_seed(ctx))
        params["_generator"] = gen
    recording = autograd.is_recording() and any(
        a._data.requires_grad for a in in_arrs)
    with torch.enable_grad() if recording else torch.no_grad():
        outs = tuple(op.fcompute(params, *[a._data for a in in_arrs]))
    n_out = op.n_out(params)
    if not getattr(_TLS, "no_aux", False):
        with torch.no_grad():
            for idx, new in zip(op.mutate_aux, outs[n_out:]):
                dst = in_arrs[idx]._data
                if new is not dst:
                    dst.copy_(new.detach())
                    in_arrs[idx]._wrote()
    out_arrs = [NDArray(v, ctx) for v in outs[:n_out]]
    if out is not None:
        dsts = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(dsts, out_arrs):
            if src.data.requires_grad:
                dst._data = src.data.to(dst._data.dtype)
            elif dst._data is not src.data:
                with torch.no_grad():
                    dst._data.copy_(src.data)
                dst._wrote()
        return out
    return out_arrs[0] if len(out_arrs) == 1 else out_arrs
