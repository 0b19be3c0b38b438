"""Sparse NDArrays: RowSparse and CSR with compact storage.

Counterpart of `mxnet_tpu/ndarray/sparse.py` (reference
`python/mxnet/ndarray/sparse.py` and the storage types of
`include/mxnet/ndarray.h`). The compact payload is the storage:
``values[nnz, ...]`` and int64 ``indices[nnz]`` for row_sparse;
``values[nnz]``, ``indices[nnz]`` and ``indptr[rows + 1]`` for CSR, as
tensors on the array's device, so memory scales with nnz and not with the
dense shape.

A dense view is made only when an op without a compact path touches the
array (``_data``, e.g. through `ops/invoke.py`), and cached. Every in-place
write (``x[:] = v``, ``x += v``, an op's ``out=x``) writes the dense view and
drops the compact form, which is then recomputed from it on demand. Unlike
the JAX package, whose arrays are immutable, the port writes into tensors in
place; so ``todense()`` returns a fresh tensor, and ``asnumpy()`` reads the
payload on the host without making a dense view on the device.

``_ensure_aux()`` hands the payload out as :class:`Payload` holders, which
numpy reads (``np.asarray``) by copying the tensor to the host; nothing else
moves the payload off its device. Conversions whose output shape depends on
the data (``nonzero``, ``unique``, boolean masks) read the device, as the JAX
package reads the host through numpy. ``dot`` keeps CSR x dense and CSR^T x
dense over the compact payload, under ``autograd.record()`` too: the taped
form is an ``autograd.Function`` whose backward is the transposed compact
product.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import Context, current_context
from .ndarray import NDArray, _default_dtype, _host_tensor
from .ndarray import zeros as nd_zeros

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "zeros", "empty",
           "retain", "dot", "add_rows"]


class Payload:
    """One array of a compact payload as ``_ensure_aux()`` hands it out:
    its tensor stays on the array's device, and numpy reads it
    (``np.asarray``) as a host copy."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor

    def __array__(self, dtype=None, copy=None):
        t = self.tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.to("cpu", copy=True).numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


class BaseSparseNDArray(NDArray):
    """Compact-first sparse array. The compact payload (``_aux``, a dict of
    tensors) is authoritative while it exists; a dense view (``_dense``) is
    made from it on first touch of ``_data``. A write into the dense view
    drops ``_aux``, and the compact form is recomputed from the dense one
    when it is asked for."""

    # '_data' is not a slot here: the property below shadows NDArray's
    __slots__ = ("_aux", "_dense", "_shape", "_dtype")

    def __init__(self, aux, shape, dtype, ctx):
        self._ctx = ctx
        self._aux = dict(aux)
        self._dense = None
        self._shape = tuple(int(s) for s in shape)
        self._dtype = dtype

    # -- the dense view ----------------------------------------------------
    @property
    def _data(self):
        if self._dense is None:
            self._dense = self._materialize()
        return self._dense

    @_data.setter
    def _data(self, value):
        self._dense = value
        if value is not None:
            self._aux = None
            self._shape = tuple(value.shape)
            self._dtype = value.dtype

    @property
    def shape(self):
        return self._shape if self._dense is None \
            else tuple(self._dense.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._dtype if self._dense is None
                           else self._dense.dtype)

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def ndim(self):
        return len(self.shape)

    def _device(self):
        if self._aux is not None:
            return self._aux["values"].device
        return self._dense.device

    def _materialize(self, device=None, dtype=None):
        raise NotImplementedError

    def _compact_from_dense(self, dense):
        raise NotImplementedError

    def _compact(self):
        """The compact payload as a dict of tensors, recomputed from the
        dense view after a write."""
        if self._aux is None:
            self._aux = self._compact_from_dense(self._dense.detach())
        return self._aux

    def _set_compact(self, aux):
        """Make ``aux`` (tensors on this array's device) the payload and
        drop the dense view."""
        self._aux = dict(aux)
        self._dense = None
        self._dtype = aux["values"].dtype

    def _ensure_aux(self):
        """The payload as :class:`Payload` holders (numpy reads them as
        host copies)."""
        return {k: Payload(v) for k, v in self._compact().items()}

    def has_compact(self):
        """True while the compact payload is authoritative (no write went
        into the dense view since it was set): the state the lazy
        row-sparse updates take."""
        return self._aux is not None

    @property
    def nnz(self):
        return int(self._compact()["values"].shape[0])

    @property
    def data(self):
        """The stored values, as a dense NDArray of their own."""
        return NDArray(self._compact()["values"].clone(), self._ctx)

    @property
    def indices(self):
        return NDArray(self._compact()["indices"].clone(), self._ctx)

    # -- writes ------------------------------------------------------------
    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._wrote()

    def _inplace(self, result):
        out = super()._inplace(result)
        if out is not NotImplemented:
            self._wrote()
        return out

    def _wrote(self):
        self._aux = None

    # -- reads and copies --------------------------------------------------
    def asnumpy(self):
        if self._dense is not None:
            return super().asnumpy()
        dense = self._materialize(torch.device("cpu"))
        return dense.numpy() if dense.dtype != torch.bfloat16 else \
            dense.float().numpy()

    def todense(self):
        """A dense NDArray with this array's values (a tensor of its own)."""
        t = self._materialize() if self._dense is None \
            else self._dense.detach().clone()
        return NDArray(t, self._ctx)

    tostype_dense = todense

    def tostype(self, stype):
        return cast_storage(self, stype)

    def copy(self):
        aux = {k: v.clone() for k, v in self._compact().items()}
        return type(self)(aux, self.shape, self._dtype, self._ctx)

    def copyto(self, other):
        """Copy into ``other`` (a sparse array of this storage type or a
        dense NDArray, of this shape) or onto a Context (a sparse array of
        this type there): the payload moves, not a dense view."""
        if isinstance(other, Context):
            dev = other.torch_device()
            aux = {k: v.to(dev, copy=True) for k, v in
                   self._compact().items()}
            return type(self)(aux, self.shape, self._dtype, other)
        if not isinstance(other, NDArray):
            raise TypeError("copyto does not support type "
                            + str(type(other)))
        if other.shape != self.shape:
            raise MXNetError("copyto: shape mismatch %s vs %s"
                             % (self.shape, other.shape))
        if isinstance(other, BaseSparseNDArray):
            src = self if other.stype == self.stype else \
                cast_storage(self, other.stype)
            dev, dt = other._device(), other._dtype if other._dense is None \
                else other._dense.dtype
            aux = {k: v.to(dev, copy=True) for k, v in
                   src._compact().items()}
            aux["values"] = aux["values"].to(dt)
            other._set_compact(aux)
            return other
        self._scatter_into(other)
        return other

    def _scatter_into(self, other):
        other[:] = self._materialize(other.data.device, other.data.dtype)

    def as_in_context(self, context):
        if self._ctx == context:
            return self
        return self.copyto(context)

    def __repr__(self):
        return "\n%s\n<%s %s @%s>" % (str(self.asnumpy()),
                                      type(self).__name__,
                                      "x".join(map(str, self.shape)),
                                      self._ctx)


def _csr_rows(indptr, n_rows, nnz):
    """The row of each stored value of a CSR payload."""
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), indptr.diff(),
        output_size=nnz)


class CSRNDArray(BaseSparseNDArray):
    __slots__ = ()

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self):
        return NDArray(self._compact()["indptr"].clone(), self._ctx)

    def _materialize(self, device=None, dtype=None):
        aux = self._aux
        device = device or aux["values"].device
        vals = aux["values"].to(device, dtype or self._dtype)
        cols = aux["indices"].to(device)
        indptr = aux["indptr"].to(device)
        rows = _csr_rows(indptr, self._shape[0], vals.shape[0])
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=device)
        dense[rows, cols] = vals
        return dense

    def _compact_from_dense(self, dense):
        rows, cols = dense.nonzero(as_tuple=True)
        indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                             device=dense.device)
        indptr[1:] = torch.bincount(rows, minlength=dense.shape[0]).cumsum(0)
        return {"values": dense[rows, cols], "indices": cols,
                "indptr": indptr}


class RowSparseNDArray(BaseSparseNDArray):
    __slots__ = ()

    @property
    def stype(self):
        return "row_sparse"

    def compact(self):
        """(values, indices) tensors: the O(nnz) payload."""
        aux = self._compact()
        return aux["values"], aux["indices"]

    def retain(self, row_ids):
        return retain(self, row_ids)

    def _materialize(self, device=None, dtype=None):
        vals, idx = self.compact()
        device = device or vals.device
        dense = torch.zeros(self._shape, dtype=dtype or self._dtype,
                            device=device)
        if vals.shape[0]:
            dense.index_copy_(0, idx.to(device), vals.to(device, dense.dtype))
        return dense

    def _compact_from_dense(self, dense):
        flat = dense.reshape(dense.shape[0], -1)
        nz = flat.ne(0).any(1).nonzero().flatten()
        return {"values": dense.index_select(0, nz), "indices": nz}

    def _scatter_into(self, other):
        """Write the stored rows into a dense NDArray and zero the rest,
        without a dense view of this array."""
        vals, idx = self.compact()
        t = other.data
        with torch.no_grad():
            t.zero_()
            if vals.shape[0]:
                t.index_copy_(0, idx.to(t.device), vals.to(t.device, t.dtype))
        other._wrote()


def _tensor(x, device, dtype=None):
    """``x`` (NDArray, tensor, numpy array or list) as a tensor on
    ``device``: of ``dtype``, else of the dtype ``nd.array`` would give."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, Payload):
        t = x.tensor.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        arr = np.asarray(x)
        t = _host_tensor(arr, torch_dtype(arr.dtype))
    dt = torch_dtype(dtype) if dtype is not None else _default_dtype(t)
    return t.to(device=device, dtype=dt, copy=True)


def _ctx_of(source, ctx):
    if ctx is not None:
        return ctx
    return source.context if isinstance(source, NDArray) \
        else current_context()


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` with ``shape``, or from
    a dense source. The compact triple is the storage: no dense buffer is
    made."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("csr_matrix from (data, indices, indptr) needs "
                             "shape")
        ctx = _ctx_of(data, ctx)
        dev = ctx.torch_device()
        vals = _tensor(data, dev, dtype)
        aux = {"values": vals,
               "indices": _tensor(indices, dev, torch.int64),
               "indptr": _tensor(indptr, dev, torch.int64)}
        return CSRNDArray(aux, shape, vals.dtype, ctx)
    ctx = _ctx_of(arg1, ctx)
    return _dense_to_csr(_tensor(arg1, ctx.torch_device(), dtype), ctx)


def _dense_to_csr(dense, ctx):
    if dense.dim() != 2:
        raise MXNetError("csr storage is 2-D; got shape %s"
                         % (tuple(dense.shape),))
    out = CSRNDArray({}, dense.shape, dense.dtype, ctx)
    out._aux = out._compact_from_dense(dense.detach())
    return out


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` with ``shape``, or from a
    dense source (its rows with any non-zero value)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise MXNetError("row_sparse_array from (data, indices) needs "
                             "shape")
        ctx = _ctx_of(data, ctx)
        dev = ctx.torch_device()
        vals = _tensor(data, dev, dtype)
        aux = {"values": vals, "indices": _tensor(indices, dev, torch.int64)}
        return RowSparseNDArray(aux, shape, vals.dtype, ctx)
    ctx = _ctx_of(arg1, ctx)
    return _dense_to_row_sparse(_tensor(arg1, ctx.torch_device(), dtype),
                                ctx)


def _dense_to_row_sparse(dense, ctx):
    out = RowSparseNDArray({}, dense.shape, dense.dtype, ctx)
    out._aux = out._compact_from_dense(dense.detach())
    return out


def cast_storage(arr, stype):
    """Reference `tensor/cast_storage-inl.h`: dense <-> row_sparse <-> csr.
    Between the two sparse types the payload converts without a dense
    view."""
    if stype == arr.stype:
        return arr
    if stype == "default":
        return arr.todense()
    if isinstance(arr, BaseSparseNDArray) and arr.has_compact():
        if isinstance(arr, RowSparseNDArray) and stype == "csr":
            if arr.ndim != 2:
                raise MXNetError("csr storage is 2-D; got shape %s"
                                 % (arr.shape,))
            return _rs_to_csr(arr._compact(), arr.shape, arr.ctx)
        if isinstance(arr, CSRNDArray) and stype == "row_sparse":
            return _csr_to_rs(arr._compact(), arr.shape, arr.ctx)
    if stype == "csr":
        return _dense_to_csr(arr._data, arr.ctx)
    if stype == "row_sparse":
        return _dense_to_row_sparse(arr._data, arr.ctx)
    raise MXNetError("unknown storage type " + str(stype))


def _rs_to_csr(aux, shape, ctx):
    """row_sparse -> csr over the payload: each stored row expanded, in
    row order whatever the order of the stored indices."""
    ridx, order = aux["indices"].sort(stable=True)
    vals = aux["values"].index_select(0, order)
    nz_r, nz_c = vals.nonzero(as_tuple=True)
    counts = torch.zeros(shape[0], dtype=torch.int64, device=vals.device)
    counts[ridx] = torch.bincount(nz_r, minlength=vals.shape[0])
    indptr = torch.zeros(shape[0] + 1, dtype=torch.int64, device=vals.device)
    indptr[1:] = counts.cumsum(0)
    return CSRNDArray({"values": vals[nz_r, nz_c], "indices": nz_c,
                       "indptr": indptr}, shape, vals.dtype, ctx)


def _csr_to_rs(aux, shape, ctx):
    vals, cols, indptr = aux["values"], aux["indices"], aux["indptr"]
    counts = indptr.diff()
    nz_rows = counts.nonzero().flatten()
    out = torch.zeros((nz_rows.shape[0],) + tuple(shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    rows = _csr_rows(indptr, shape[0], vals.shape[0])
    remap = torch.zeros(shape[0], dtype=torch.int64, device=vals.device)
    remap[nz_rows] = torch.arange(nz_rows.shape[0], device=vals.device)
    out[remap[rows], cols] = vals
    return RowSparseNDArray({"values": out, "indices": nz_rows}, shape,
                            vals.dtype, ctx)


def zeros(stype, shape, ctx=None, dtype=None):
    if stype == "default":
        return nd_zeros(shape, ctx=ctx, dtype=dtype)
    dt = torch_dtype(dtype)
    ctx = ctx or current_context()
    dev = ctx.torch_device()
    shape = tuple(shape)
    idx = torch.zeros((0,), dtype=torch.int64, device=dev)
    if stype == "csr":
        return CSRNDArray(
            {"values": torch.zeros((0,), dtype=dt, device=dev),
             "indices": idx,
             "indptr": torch.zeros(shape[0] + 1, dtype=torch.int64,
                                   device=dev)}, shape, dt, ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            {"values": torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
             "indices": idx}, shape, dt, ctx)
    raise MXNetError("unknown storage type " + str(stype))


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx, dtype)


def _row_ids(row_ids, device):
    """Row ids (an NDArray, possibly float as the examples pass them, or
    a sequence) as int64 on ``device``."""
    if isinstance(row_ids, NDArray):
        return row_ids._data.detach().to(device, torch.int64)
    return torch.as_tensor(np.asarray(row_ids, np.int64), device=device)


def retain(arr, row_ids):
    """Reference sparse_retain: keep only the given rows, over the compact
    payload (never a dense view)."""
    vals, idx = arr.compact()
    keep = torch.isin(idx, _row_ids(row_ids, idx.device))
    return RowSparseNDArray({"values": vals[keep], "indices": idx[keep]},
                            arr.shape, vals.dtype, arr.ctx)


def add_rows(a, b):
    """row_sparse + row_sparse -> row_sparse over the payloads: the index
    sets merged (sorted, as ``np.unique``) and duplicate rows summed
    (reference ElemwiseBinaryOp rsp+rsp)."""
    va, ia = a.compact()
    vb, ib = b.compact()
    dev = va.device
    vb, ib = vb.to(dev), ib.to(dev)
    merged, inv = torch.unique(torch.cat([ia, ib]), sorted=True,
                               return_inverse=True)
    out = torch.zeros((merged.shape[0],) + tuple(va.shape[1:]),
                      dtype=torch.promote_types(va.dtype, vb.dtype),
                      device=dev)
    out.index_add_(0, inv[:ia.shape[0]], va.to(out.dtype))
    out.index_add_(0, inv[ia.shape[0]:], vb.to(out.dtype))
    return RowSparseNDArray({"values": out, "indices": merged}, a.shape,
                            out.dtype, a.ctx)


def _csr_payload(csr):
    aux = csr._compact()
    rows = _csr_rows(aux["indptr"], csr.shape[0], aux["values"].shape[0])
    return aux["values"], aux["indices"], rows


def _csr_dot_impl(vals, cols, rows, shape, rhs, transpose_a):
    """CSR (or its transpose) x dense over the payload, O(nnz * k): the
    rhs rows gathered, scaled by the stored values and summed into the
    output rows (``index_add_``; on the card its atomics sum in an order
    that varies from run to run)."""
    src, dst, n_out = (cols, rows, shape[0]) if not transpose_a \
        else (rows, cols, shape[1])
    gathered = rhs.index_select(0, src) * vals[:, None].to(rhs.dtype)
    out = torch.zeros((n_out, rhs.shape[1]), dtype=rhs.dtype,
                      device=rhs.device)
    return out.index_add_(0, dst, gathered)


def _csr_dot_function(csr, transpose_a):
    """The taped compact product (reference dot-inl.h forward and
    backward): the gradient to the dense rhs is the transposed compact
    product of the output's gradient. The CSR payload takes no gradient,
    as in the reference."""
    from ..autograd import Function
    payload = _csr_payload(csr)       # computed once, for both passes

    class _CSRDot(Function):
        def forward(self, rhs):
            return NDArray(_csr_dot_impl(*payload, csr.shape, rhs.data,
                                         transpose_a), csr.ctx)

        def backward(self, dy):
            return NDArray(_csr_dot_impl(*payload, csr.shape, dy.data,
                                         not transpose_a), csr.ctx)

    return _CSRDot()


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (reference tensor/dot-inl.h). CSR x dense and
    CSR^T x dense run over the compact payload, recorded under
    ``autograd.record()`` with the transposed compact product as their
    backward; every other combination takes the dense ``dot`` op."""
    from .. import autograd
    if isinstance(lhs, CSRNDArray) and lhs.has_compact() and \
            not transpose_b and isinstance(rhs, NDArray) and \
            not isinstance(rhs, BaseSparseNDArray) and rhs.ndim == 2:
        if autograd.is_recording():
            return _csr_dot_function(lhs, transpose_a)(rhs)
        return NDArray(_csr_dot_impl(*_csr_payload(lhs), lhs.shape,
                                     rhs.data, transpose_a), lhs.ctx)
    from ..ops.invoke import invoke
    return invoke("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                      "transpose_b": transpose_b})
