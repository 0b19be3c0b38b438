"""NDArray: a thin handle over a ``torch.Tensor``.

Counterpart of `mxnet_tpu/ndarray/ndarray.py`, cut to what the serving,
training and Gluon paths use: shape/size/dtype/context, ``asnumpy``,
views by basic indexing, in-place assignment (the Predictor and Module
feed inputs with ``arr[:] = value``), arithmetic through the registered
``broadcast_*`` and scalar ops (`ops/invoke.py`), and the ``zeros``/
``array`` constructors. Unlike the JAX package, whose arrays are
immutable and rebound on assignment, ``arr[:] = value`` here copies into
the existing tensor, so every executor sharing the buffer sees it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "zeros", "array"]


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
    def context(self):
        return self._ctx

    @property
    def data(self) -> torch.Tensor:
        """The underlying tensor (shared, not copied)."""
        return self._data

    def asnumpy(self):
        """A numpy copy of the values as they are now; later writes into
        this NDArray do not show in it."""
        return self._data.detach().to("cpu", copy=True).numpy()

    # -- arithmetic through the registered ops ---------------------------
    def _binary(self, other, op, scalar_op):
        from ..ops.invoke import invoke
        if isinstance(other, NDArray):
            return invoke(op, [self, other])
        if isinstance(other, (int, float)):
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
        from ..ops.invoke import invoke
        return invoke("negative", [self])

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
        if isinstance(key, slice) and key == slice(None):
            if src.dim() and tuple(src.shape) != self.shape:
                raise MXNetError("cannot assign shape %s to NDArray of shape "
                                 "%s" % (tuple(src.shape), self.shape))
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


def array(source, ctx=None, dtype=None):
    """Copy ``source`` (numpy, list, tensor or NDArray) onto ``ctx``;
    dtype defaults to float32 as in the reference."""
    ctx = ctx or current_context()
    dt = torch_dtype(dtype)
    if isinstance(source, NDArray):
        source = source._data
    if not isinstance(source, torch.Tensor):
        source = _host_tensor(source, dt)
    return NDArray(source.to(device=ctx.torch_device(), dtype=dt, copy=True),
                   ctx)
