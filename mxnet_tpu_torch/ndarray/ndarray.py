"""NDArray: a thin handle over a ``torch.Tensor``.

Counterpart of `mxnet_tpu/ndarray/ndarray.py`: shape/size/dtype/context,
``asnumpy``/``asscalar``, views by basic indexing, in-place assignment
(the Predictor and Module feed inputs with ``arr[:] = value``), the
arithmetic, comparison (``==`` and ``!=`` elementwise, 0/1 in the
array's dtype, the array staying hashable by identity), ``**``, ``%``
and ``@`` operators, the JAX package's methods over the registered ops
(`ops/invoke.py`, so they are recorded under ``autograd.record()``), the
autograd surface (``attach_grad``, ``grad``, ``backward``, ``detach``)
and the constructors (``array``, ``zeros``, ``ones``, ``full``,
``empty``, ``arange``, ``concatenate``, ``moveaxis``). ``stype`` is
``"default"``; ``tostype`` converts to the sparse storage types of
`ndarray/sparse.py`, whose arrays are NDArrays too. Unlike the JAX
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

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "moveaxis", "waitall"]


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
    # numpy defers its binary operators to the NDArray's reflected ones
    __array_priority__ = 1000.0

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

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    def tostype(self, stype):
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def _wrote(self):
        """Called after a write into this array's tensor from outside
        (an op's ``out=``, a scatter): a sparse array drops its compact
        form here."""

    def as_np(self):
        """The underlying tensor (the JAX package returns its array)."""
        return self._data

    def wait_to_read(self):
        """Wait for the card to finish the work queued on this array's
        device."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy of the values as they are now; later writes into
        this NDArray do not show in it."""
        return self._data.detach().to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def astype(self, dtype, copy=True):
        if not copy and torch_dtype(dtype) == self._data.dtype:
            return self
        return self._invoke("Cast", dtype=dtype)

    def copy(self):
        return self._invoke("_copy")

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

    def slice_assign(self, rhs, begin, end, step=None):
        key = tuple(slice(b, e, s) for b, e, s in
                    zip(begin, end, step or [None] * len(begin)))
        self[key] = rhs
        return self

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape", ())
        return self._invoke("Reshape", shape=tuple(shape))

    def reshape_like(self, other):
        return self._invoke("reshape_like", other)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._invoke("transpose", axes=axes or None)

    def swapaxes(self, dim1, dim2):
        return self._invoke("SwapAxis", dim1=dim1, dim2=dim2)

    def flatten(self):
        return self._invoke("Flatten")

    def expand_dims(self, axis):
        return self._invoke("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._invoke("squeeze", axis=axis)

    def broadcast_to(self, shape):
        return self._invoke("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other):
        return self._invoke("broadcast_like", other)

    def tile(self, reps):
        return self._invoke("tile", reps=tuple(reps) if isinstance(
            reps, (list, tuple)) else (reps,))

    def repeat(self, repeats, axis=None):
        return self._invoke("repeat", repeats=repeats, axis=axis)

    def pad(self, mode, pad_width, constant_value=0):
        return self._invoke("Pad", mode=mode, pad_width=pad_width,
                            constant_value=constant_value)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._invoke("SliceChannel", num_outputs=num_outputs,
                            axis=axis, squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=None):
        return self._invoke("slice", begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return self._invoke("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._invoke("take", indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return self._invoke("pick", index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return self._invoke("one_hot", depth=depth, on_value=on_value,
                            off_value=off_value, dtype=dtype)

    def clip(self, a_min, a_max):
        return self._invoke("clip", a_min=a_min, a_max=a_max)

    def flip(self, axis):
        return self._invoke("flip", axis=axis)

    def diag(self, k=0):
        return self._invoke("diag", k=k)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._invoke("norm", ord=ord, axis=axis, keepdims=keepdims)

    def dot(self, other, **kw):
        return self._invoke("dot", other, **kw)

    def softmax(self, axis=-1, **kw):
        return self._invoke("softmax", axis=axis, **kw)

    def log_softmax(self, axis=-1, **kw):
        return self._invoke("log_softmax", axis=axis, **kw)

    def argmax(self, axis=None, keepdims=False):
        return self._invoke("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._invoke("argmin", axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return self._invoke("argsort", axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return self._invoke("sort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._invoke("topk", axis=axis, k=k, ret_typ=ret_typ,
                            is_ascend=is_ascend)

    def _reduce(self, op, axis, keepdims, kw):
        return self._invoke(op, axis=axis, keepdims=keepdims, **kw)

    def sum(self, axis=None, keepdims=False, **kw):
        return self._reduce("sum", axis, keepdims, kw)

    def nansum(self, axis=None, keepdims=False, **kw):
        return self._reduce("nansum", axis, keepdims, kw)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._reduce("mean", axis, keepdims, kw)

    def max(self, axis=None, keepdims=False, **kw):
        return self._reduce("max", axis, keepdims, kw)

    def min(self, axis=None, keepdims=False, **kw):
        return self._reduce("min", axis, keepdims, kw)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._reduce("prod", axis, keepdims, kw)

    def _binary(self, other, op, scalar_op, reverse=False):
        """``self op other`` (with ``reverse``, ``other op self``) for an
        NDArray, a real scalar or a numpy array (copied onto this array's
        context)."""
        from ..ops.invoke import invoke
        if isinstance(other, NDArray):
            return invoke(op, [self, other])
        if isinstance(other, numbers.Real):
            return invoke(scalar_op, [self], {"scalar": float(other)})
        if isinstance(other, np.ndarray):
            other = array(other, ctx=self._ctx)
            return invoke(op, [other, self] if reverse else [self, other])
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", "_rminus_scalar", True)

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_rdiv_scalar", True)

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binary(other, "broadcast_mod", "_rmod_scalar", True)

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binary(other, "broadcast_power", "_rpower_scalar",
                            True)

    def __matmul__(self, other):
        return self._invoke("dot", other)

    def __neg__(self):
        return self._invoke("negative")

    def __abs__(self):
        return self._invoke("abs")

    def __eq__(self, other):
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return self._binary(other, "broadcast_not_equal",
                            "_not_equal_scalar")

    def __hash__(self):
        return id(self)

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
        """A view (basic indexing), as in the reference; an NDArray index
        gathers."""
        return NDArray(self._data[_index(key)], self._ctx)

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
                self._data[_index(key)] = src.to(self._data.device,
                                                 self._data.dtype)

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(d) for d in self.shape), self._ctx)


def _index(key):
    """``key`` with its NDArrays replaced by their tensors."""
    if isinstance(key, NDArray):
        return key.data
    if isinstance(key, tuple):
        return tuple(k.data if isinstance(k, NDArray) else k for k in key)
    return key


def _unary_method(op):
    def method(self):
        return self._invoke(op)
    method.__name__ = op
    return method


for _op in ("abs", "sign", "sqrt", "square", "exp", "log", "relu",
            "sigmoid", "tanh"):
    setattr(NDArray, _op, _unary_method(_op))


def _shape(shape):
    return (shape,) if isinstance(shape, numbers.Integral) else tuple(shape)


def _device_of(ctx):
    ctx = ctx or current_context()
    return ctx, ctx.torch_device()


def zeros(shape, ctx=None, dtype=None, **kwargs):
    ctx, dev = _device_of(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=dev), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    ctx, dev = _device_of(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=dev), ctx)


def full(shape, val, ctx=None, dtype=None):
    ctx, dev = _device_of(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=dev), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``[start, stop)`` by ``step`` (``[0, start)`` without ``stop``),
    each value ``repeat`` times; f32 unless ``dtype`` says otherwise."""
    from ..ops.invoke import invoke
    ctx = ctx or current_context()
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "dtype": dtype}, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    from ..ops.invoke import invoke
    return invoke("Concat", list(arrays), {"dim": axis})


def moveaxis(tensor, source, destination):
    from ..ops.invoke import invoke
    perm = [i for i in range(tensor.ndim) if i != source % tensor.ndim]
    perm.insert(destination % tensor.ndim, source % tensor.ndim)
    return invoke("transpose", [tensor], {"axes": tuple(perm)})


def waitall():
    """Wait for every queued operation on the card (a no-op without
    one)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _default_dtype(source):
    """The dtype ``array`` gives ``source`` when none is asked for, by the
    JAX package's rules: an NDArray's or tensor's own, a numpy array's
    own, int32 for Python ints that fit, and f32 for float64."""
    if isinstance(source, NDArray):
        return source.data.dtype
    if isinstance(source, torch.Tensor):
        dt = source.dtype
    else:
        arr = np.asarray(source)
        dt = torch_dtype(arr.dtype)
        if dt == torch.int64 and not isinstance(source, np.ndarray) and \
                arr.size and np.abs(arr).max() < 2 ** 31:
            dt = torch.int32
    return torch.float32 if dt == torch.float64 else dt


def array(source, ctx=None, dtype=None):
    """Copy ``source`` (NDArray, tensor, numpy array, list or scalar) onto
    ``ctx``: an NDArray's own context by default, else the current one.
    Without ``dtype``, an NDArray or numpy array keeps its dtype, a
    Python int list becomes int32 and float64 becomes f32, as in the JAX
    package."""
    dt = torch_dtype(dtype) if dtype is not None else _default_dtype(source)
    if isinstance(source, NDArray):
        ctx = ctx or source.context
        source = source.data.detach()
    ctx = ctx or current_context()
    if not isinstance(source, torch.Tensor):
        source = _host_tensor(source, dt)
    return NDArray(source.to(device=ctx.torch_device(), dtype=dt, copy=True),
                   ctx)
