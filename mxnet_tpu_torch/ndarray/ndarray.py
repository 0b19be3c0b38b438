"""NDArray: a thin handle over a ``torch.Tensor``.

Counterpart of `mxnet_tpu/ndarray/ndarray.py`, cut to what the serving,
training and Gluon paths use: shape/size/dtype/context, ``asnumpy``,
views by basic indexing, in-place assignment (the Predictor and Module
feed inputs with ``arr[:] = value``), arithmetic, comparisons, ``sum``,
``mean`` and ``astype`` through the registered ops (`ops/invoke.py`, so
they are recorded under ``autograd.record()``), the autograd surface
(``attach_grad``, ``grad``, ``backward``, ``detach``) and the ``zeros``/
``array`` constructors. Unlike the JAX
package, whose arrays are immutable and rebound on assignment,
``arr[:] = value`` here copies into the existing tensor (under
``torch.no_grad()``: the tensor may be an autograd leaf), so every
executor sharing the buffer sees it; ``a += b`` does the same, except
where the result is on the tape, where it rebinds ``a`` to the result as
the JAX package does.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "zeros", "array", "waitall"]


def _host_tensor(value, dtype):
    """numpy/list/scalar -> CPU tensor of ``dtype`` (no copy when the
    array already matches; read-only arrays are copied, since torch
    refuses to alias them)."""
    arr = np.asarray(value)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(dtype)


class NDArray:
    __slots__ = ("_data", "_ctx")

    def __init__(self, data: torch.Tensor, ctx: Context):
        self._data = data
        self._ctx = ctx

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        """numpy dtype, as in the JAX package (bfloat16 raises)."""
        return numpy_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def data(self) -> torch.Tensor:
        """The underlying tensor (shared, not copied)."""
        return self._data

    def asnumpy(self):
        """A numpy copy of the values as they are now; later writes into
        this NDArray do not show in it."""
        return self._data.detach().to("cpu", copy=True).numpy()

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def astype(self, dtype, copy=True):
        if not copy and torch_dtype(dtype) == self._data.dtype:
            return self
        return self._invoke("Cast", dtype=dtype)

    def copyto(self, other):
        """Copy into ``other`` (an NDArray of this shape, cast to its
        dtype) or onto a Context (a new NDArray there)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            other[:] = self
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), other)
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if self._ctx == context:
            return self
        return self.copyto(context)

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf of the tape with a zero ``.grad`` of its
        shape and dtype, written by backward as ``grad_req`` says."""
        from .. import autograd
        autograd.mark_variables([self], [NDArray(
            torch.zeros_like(self._data, requires_grad=False), self._ctx)],
            grad_req)

    @property
    def grad(self):
        """The gradient buffer of an array made a leaf by ``attach_grad``
        (or ``autograd.mark_variables``), else None."""
        slot = getattr(self._data, "_mx_grad_slot", None)
        return None if slot is None else slot.grad

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        """The same values, off the tape."""
        return NDArray(self._data.detach(), self._ctx)

    # -- methods over the registered ops -----------------------------------
    def _invoke(self, op, *others, **params):
        from ..ops.invoke import invoke
        return invoke(op, [self, *others], params)

    def sum(self, axis=None, keepdims=False, **kw):
        return self._invoke("sum", axis=axis, keepdims=keepdims, **kw)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._invoke("mean", axis=axis, keepdims=keepdims, **kw)

    def _binary(self, other, op, scalar_op):
        from ..ops.invoke import invoke
        if isinstance(other, NDArray):
            return invoke(op, [self, other])
        if isinstance(other, numbers.Real):
            return invoke(scalar_op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_rdiv_scalar")

    def __neg__(self):
        return self._invoke("negative")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def _inplace(self, result):
        """``self op= other``: a result on the tape rebinds this array to
        it (the JAX package's rebinding); any other is copied into this
        array's tensor, so arrays sharing the buffer see it."""
        if result is NotImplemented:
            return result
        if result._data.requires_grad:
            self._data = result._data
        else:
            with torch.no_grad():
                self._data.copy_(result._data)
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    def __getitem__(self, key):
        """A view (basic indexing), as in the reference."""
        return NDArray(self._data[key], self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            src = value._data
        elif isinstance(value, torch.Tensor):
            src = value
        else:
            src = _host_tensor(value, self._data.dtype)
        with torch.no_grad():
            if isinstance(key, slice) and key == slice(None):
                if src.dim() and tuple(src.shape) != self.shape:
                    raise MXNetError("cannot assign shape %s to NDArray of "
                                     "shape %s" % (tuple(src.shape),
                                                   self.shape))
                self._data.copy_(src)
            else:
                self._data[key] = src.to(self._data.device, self._data.dtype)

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(d) for d in self.shape), self._ctx)


def zeros(shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def waitall():
    """Wait for every queued operation on the card (a no-op without
    one)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def array(source, ctx=None, dtype=None):
    """Copy ``source`` (numpy, list, tensor or NDArray) onto ``ctx``;
    dtype defaults to float32 as in the reference."""
    ctx = ctx or current_context()
    dt = torch_dtype(dtype)
    if isinstance(source, NDArray):
        source = source._data.detach()
    if not isinstance(source, torch.Tensor):
        source = _host_tensor(source, dt)
    return NDArray(source.to(device=ctx.torch_device(), dtype=dt, copy=True),
                   ctx)
