"""The lazy row-sparse optimizer update: S1 and its plain version.

S1 (``csrc/sparse_row_update.cu``) replaces no TPU kernel: it is the
counterpart of the one compiled XLA program of
`mxnet_tpu/optimizer.py::_sparse_row_update` (reference MXNet's
``SGDUpdateRspImpl``, ``AdamUpdateRspImpl``, ``AdagradUpdateRspImpl``).
:func:`sparse_row_update` applies one of ``FORMULAS`` (``sgd``,
``sgd_mom``, ``adam``, ``adagrad``) in place to the rows of a weight (f32
or bf16) and of its f32 states that a compact row-sparse gradient names
(``values`` (nnz, ...) f32 or bf16, ``indices`` (nnz,) int64 or int32,
unique), and to no other row. On CUDA tensors it launches S1 once,
whatever nnz is (0 returns before any launch); it reads nothing back from
the card, so nnz is the tensor's shape, and it does not check that the
indices are unique, which the producers guarantee (``add_rows``,
``row_sparse_pull``: sorted and deduplicated). On CPU tensors it runs
:func:`sparse_row_update_plain`: ``index_select``, the elementwise steps
of the JAX kernel in its order, and ``index_copy_``. It raises on any
other device. ``sparse_row_update.launches`` counts the calls that
launched the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch
from torch.autograd.graph import increment_version

from ..base import MXNetError
from . import _build
from .launch_count import count
from .multi_tensor import _hyper

__all__ = ["FORMULAS", "sparse_row_update", "sparse_row_update_plain"]

#: formula -> (kernel id, f32 states a weight)
FORMULAS = {"sgd": (0, 0), "sgd_mom": (1, 1), "adam": (2, 2),
            "adagrad": (3, 1)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_DTYPES = {torch.int64: 0, torch.int32: 1}
_lock = threading.Lock()


def sparse_row_update_plain(kind, weight, values, indices, states, lr,
                            wd=0.0, rescale_grad=1.0, clip_gradient=None,
                            **hyper):
    """The plain version: gather the named rows, update them in f32 in the
    JAX kernel's order, scatter them back (see the module docstring)."""
    h = _hyper(hyper)
    idx = indices.long()
    g = values.float() * rescale_grad
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    w_rows = weight.index_select(0, idx)
    g = g + wd * w_rows.float()
    if kind == "sgd":
        step = -lr * g
    elif kind == "sgd_mom":
        (m,) = states
        new_m = h["momentum"] * m.index_select(0, idx) + g
        m.index_copy_(0, idx, new_m)
        step = -lr * new_m
    elif kind == "adam":
        m, v = states
        new_m = h["beta1"] * m.index_select(0, idx) + (1.0 - h["beta1"]) * g
        new_v = h["beta2"] * v.index_select(0, idx) + \
            (1.0 - h["beta2"]) * g * g
        m.index_copy_(0, idx, new_m)
        v.index_copy_(0, idx, new_v)
        step = -(lr * new_m / (torch.sqrt(new_v) + h["epsilon"]))
    elif kind == "adagrad":
        (hist,) = states
        new_h = hist.index_select(0, idx) + g * g
        hist.index_copy_(0, idx, new_h)
        step = -(lr * g / (torch.sqrt(new_h) + h["epsilon"]))
    else:
        raise MXNetError("sparse_row_update: unknown formula %r" % (kind,))
    weight.index_copy_(0, idx, w_rows + step.to(weight.dtype))


def _check(kind, weight, values, indices, states):
    dev = weight.device
    if weight.dtype not in _DTYPES or values.dtype not in _DTYPES:
        raise MXNetError("sparse_row_update: the kernel takes f32 or bf16 "
                         "weights and values, got %s and %s"
                         % (weight.dtype, values.dtype))
    if indices.dtype not in _INDEX_DTYPES or indices.dim() != 1:
        raise MXNetError("sparse_row_update: indices must be 1-D int64 or "
                         "int32, got %s %s" % (indices.dtype,
                                               tuple(indices.shape)))
    if tuple(values.shape) != (indices.shape[0],) + tuple(weight.shape[1:]):
        raise MXNetError("sparse_row_update: values %s do not match %d rows "
                         "of a %s weight" % (tuple(values.shape),
                                             indices.shape[0],
                                             tuple(weight.shape)))
    if len(states) != FORMULAS[kind][1]:
        raise MXNetError("sparse_row_update: %s takes %d states, got %d"
                         % (kind, FORMULAS[kind][1], len(states)))
    for t in (values, indices) + tuple(states):
        if t.device != dev:
            raise MXNetError("sparse_row_update: every tensor must be on %s, "
                             "got one on %s" % (dev, t.device))
    if not weight.is_contiguous():
        raise MXNetError("sparse_row_update: the weight must be contiguous")
    for s in states:
        if s.dtype != torch.float32 or not s.is_contiguous() or \
                s.shape != weight.shape:
            raise MXNetError("sparse_row_update: states must be contiguous "
                             "f32 of the weight's shape")


def _library():
    lib = _build.library("sparse_row_update")
    with _lock:
        if lib.sparse_row_update.argtypes is None:
            vp, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                            ctypes.c_longlong)
            lib.sparse_row_update.argtypes = \
                [i] * 4 + [vp] * 5 + [ll, ll, f, f, f, i] + [f] * 7 + [vp]
            lib.sparse_row_update.restype = i
            lib.sparse_row_update_error_name.argtypes = [i]
            lib.sparse_row_update_error_name.restype = ctypes.c_char_p
    return lib


def sparse_row_update(kind, weight, values, indices, states, lr, wd=0.0,
                      rescale_grad=1.0, clip_gradient=None, **hyper):
    """Update the rows ``indices`` of ``weight`` and of ``states`` (a tuple
    of f32 tensors: ``sgd_mom`` its momentum, ``adam`` mean and variance,
    ``adagrad`` its history) in place from the gradient rows ``values``,
    by ``kind``; ``clip_gradient`` None for no clipping; ``momentum``,
    ``beta1``, ``beta2`` and ``epsilon`` as the formula takes them, Adam's
    ``lr`` already bias-corrected. S1 on CUDA tensors, the plain version
    on CPU tensors."""
    if kind not in FORMULAS:
        raise MXNetError("sparse_row_update: unknown formula %r" % (kind,))
    states = tuple(states)
    dev = weight.device
    if dev.type == "cpu":
        with torch.no_grad():
            sparse_row_update_plain(kind, weight, values, indices, states,
                                    lr, wd, rescale_grad, clip_gradient,
                                    **hyper)
        return
    if dev.type != "cuda":
        raise MXNetError("sparse_row_update: no kernel for device %s" % dev)
    values = values.contiguous()
    _check(kind, weight, values, indices, states)
    nnz = indices.shape[0]
    if nnz == 0:
        return
    h = _hyper(hyper)
    d = weight.numel() // weight.shape[0] if weight.shape[0] else 0
    ptrs = [s.data_ptr() for s in states] + [None] * (2 - len(states))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = lib.sparse_row_update(
            FORMULAS[kind][0], _DTYPES[weight.dtype], _DTYPES[values.dtype],
            _INDEX_DTYPES[indices.dtype], weight.data_ptr(), ptrs[0],
            ptrs[1], values.data_ptr(), indices.data_ptr(), nnz, d, lr, wd,
            rescale_grad, int(clip_gradient is not None),
            0.0 if clip_gradient is None else clip_gradient, h["momentum"],
            h["beta1"], 1.0 - h["beta1"], h["beta2"], 1.0 - h["beta2"],
            h["epsilon"], stream.cuda_stream)
    if err:
        raise MXNetError("sparse_row_update kernel launch failed: %s (%d)"
                         % (lib.sparse_row_update_error_name(err).decode(),
                            err))
    increment_version([weight, *states])
    count(sparse_row_update)


#: calls that launched the CUDA kernel (the plain version does not count)
sparse_row_update.launches = 0
