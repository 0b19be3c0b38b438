"""Operator registry.

Counterpart of `mxnet_tpu/ops/registry.py`, with the same ``register``
contract. An op's ``fcompute(params, *inputs)`` takes a dict of scalar
attributes and ``torch.Tensor`` inputs and returns a tuple of tensors.
``params`` also carries ``_is_train`` for ops that declare
``need_train_flag``, ``_generator`` (a ``torch.Generator`` on the
inputs' device, in place of the JAX package's ``_rng_key``) for ops that
declare ``need_rng``, and ``_ctx``, the executor's Context. An op that
draws only in some modes (``Dropout`` in training) gives ``need_rng`` as
a function of its params; an eager call that does not draw then gets no
generator, so it may run inside a CUDA graph capture.

The same fcompute runs eagerly on CUDA or CPU tensors, and on ``meta``
tensors for shape inference (`symbol/symbol.py`), so an op must not
launch a hand kernel for a tensor that is not on a CUDA device.

An op that updates some of its inputs (BatchNorm's moving statistics,
inputs 3 and 4) names their indices in ``mutate_aux`` and returns their
new values after its ``num_outputs`` regular outputs; the callers
(`ops/invoke.py`, `executor.py`) write them back. ``num_visible_outputs``
hides the tail of the regular outputs (BatchNorm's mean and var) from
symbolic composition and executor outputs.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["Operator", "register", "get_op", "populate_prefixed"]

_OPS = {}


class Operator:
    def __init__(self, name, fcompute, num_outputs=1, need_train_flag=False,
                 need_rng=False, mutate_aux=None, num_visible_outputs=None,
                 doc=""):
        self.name = name
        self.fcompute = fcompute
        # int, or callable(params)->int for variable-output ops (RNN)
        self.num_outputs = num_outputs
        self.need_train_flag = need_train_flag
        self.need_rng = need_rng
        self.mutate_aux = tuple(mutate_aux or ())
        self.num_visible_outputs = num_visible_outputs
        self.doc = doc

    def n_out(self, params):
        if callable(self.num_outputs):
            return self.num_outputs(params)
        return self.num_outputs

    def n_visible(self, params):
        if self.num_visible_outputs is None:
            return self.n_out(params)
        return self.num_visible_outputs

    def draws(self, params):
        """Whether a call with ``params`` (``_is_train`` set) draws random
        numbers."""
        if callable(self.need_rng):
            return bool(self.need_rng(params))
        return self.need_rng

    def __repr__(self):
        return "Operator(%s)" % self.name


def register(name, num_outputs=1, aliases=(), need_train_flag=False,
             need_rng=False, mutate_aux=None, num_visible_outputs=None):
    """Decorator registering ``fcompute`` under ``name`` (+aliases)."""

    def deco(fcompute):
        op = Operator(name, fcompute, num_outputs=num_outputs,
                      need_train_flag=need_train_flag, need_rng=need_rng,
                      mutate_aux=mutate_aux,
                      num_visible_outputs=num_visible_outputs,
                      doc=fcompute.__doc__ or "")
        _OPS[name] = op
        for a in aliases:
            _OPS[a] = op
        return fcompute

    return deco


def get_op(name) -> Operator:
    try:
        return _OPS[name]
    except KeyError:
        raise MXNetError("Operator %s is not registered" % name) from None


def populate_prefixed(namespace, make_fn, prefix):
    """Fill a namespace of ops by short name: every registered
    ``<prefix>Foo`` op as ``Foo``, built by ``make_fn(name)``; returns the
    short names added (the namespace's ``__all__``)."""
    names = []
    for name in list(_OPS):
        short = name[len(prefix):]
        if name.startswith(prefix) and short not in namespace:
            namespace[short] = make_fn(name)
            names.append(short)
    return names
