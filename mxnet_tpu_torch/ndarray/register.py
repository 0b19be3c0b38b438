"""Generate the ``nd.<Op>`` functions from the op registry.

Counterpart of `mxnet_tpu/ndarray/register.py`: every registered op
becomes ``op(*ndarray_inputs, out=None, ctx=None, **attrs)`` over
`ops/invoke.py`; trailing positional scalars take the names of the same
table as ``sym.<Op>``.
"""
from __future__ import annotations

from ..ops.invoke import invoke
from ..ops.registry import _OPS
from ..symbol.register import _POS_PARAMS
from .ndarray import NDArray

__all__ = ["populate"]


def _make_fn(name):
    pos_params = _POS_PARAMS.get(name, ())

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("name", None)
        inputs = []
        extra_pos = []
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a and \
                    isinstance(a[0], NDArray):
                inputs.extend(a)
            else:
                extra_pos.append(a)
        if len(extra_pos) > len(pos_params):
            raise TypeError("%s: too many positional attribute args (%d)"
                            % (name, len(extra_pos)))
        for pname, pval in zip(pos_params, extra_pos):
            kwargs.setdefault(pname, pval)
        attrs = {}
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                inputs.append(v)
            else:
                attrs[k] = v
        return invoke(name, inputs, attrs, ctx=ctx, out=out)

    fn.__name__ = name
    return fn


def populate(namespace):
    for name in list(_OPS):
        namespace.setdefault(name, _make_fn(name))
