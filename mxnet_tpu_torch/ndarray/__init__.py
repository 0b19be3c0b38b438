"""`mx.nd` namespace of the port (reference `python/mxnet/ndarray/`):
the NDArray, its constructors, the ``.params`` format, one function per
registered op (``maximum`` and ``minimum`` also take a scalar on either
side; ``onehot_encode`` is ``one_hot``, as in the JAX package),
``nd.contrib`` and the samplers of ``nd.random``."""
import numbers as _numbers

from .. import ops as _ops  # noqa: F401  (registers the operators)
from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      concatenate, moveaxis, waitall)
from .utils import save, load, load_frombuffer
from .register import populate as _populate

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "moveaxis", "waitall", "save", "load",
           "load_frombuffer"]

_populate(globals())
onehot_encode = globals()["one_hot"]


def _with_scalar(op, scalar_op):
    """``op(lhs, rhs)`` whose operands may be a scalar on either side."""
    from ..ops.invoke import invoke

    def fn(lhs, rhs, **kw):
        if isinstance(rhs, _numbers.Real):
            return invoke(scalar_op, [lhs], {"scalar": float(rhs)})
        if isinstance(lhs, _numbers.Real):
            return invoke(scalar_op, [rhs], {"scalar": float(lhs)})
        return op(lhs, rhs, **kw)
    fn.__name__ = op.__name__
    return fn


maximum = _with_scalar(globals()["maximum"], "_maximum_scalar")
minimum = _with_scalar(globals()["minimum"], "_minimum_scalar")
from . import contrib  # noqa: E402,F401
from . import random  # noqa: E402,F401
from . import sparse  # noqa: E402,F401
