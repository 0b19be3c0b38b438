"""One launch that updates a whole list of tensors: U1 and its plain version.

U1 is the counterpart of the one compiled program that
`mxnet_tpu/optimizer.py`'s ``FusedApplier`` traces over every parameter
(an XLA program; no TPU kernel of the repository). ``multi_tensor_update``
applies one of six formulas of `ops/optimizer_ops.py` (``FORMULAS``) to
lists of weights, gradients and f32 states, with a learning rate and a
weight decay per tensor. On CUDA tensors it launches
``csrc/multi_tensor_update.cu`` once for the whole list; on CPU tensors it
runs :func:`multi_tensor_update_plain`, a loop over the per-tensor
functions of `ops/optimizer_ops.py`, which is also the kernel's reference
on the card. It raises on any other device, and on a CUDA list the kernel
cannot take (weights other than f32 or bf16, a gradient of another dtype,
states other than contiguous f32 of the weight's size), which it checks
whenever it builds the list's table.

The kernel reads its list from device memory: a table of each tensor's
pointers and size and the (tensor, chunk) pairs its blocks walk, cached
in an :class:`UpdateBuffers` on the tuple of the tensors' addresses and
rebuilt when one changes (a state loaded from a file, a ``cast``); and a
device vector of each tensor's lr and wd, copied from pinned host memory
every call. The host writes a pinned slot again only after the copy that
read it last has run (a ring of slots, each with an event), so a queued
copy never reads the next call's values. The kernel writes weights that
may be autograd leaves behind autograd's back; the wrapper bumps every
written tensor's version counter, so a graph that saved one raises on
backward as after an in-place op. ``multi_tensor_update.launches``
counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch
from torch.autograd.graph import increment_version

from ..base import MXNetError
from . import _build
from .launch_count import count
from .optimizer_ops import (adam_update, mp_adam_update, mp_sgd_mom_update,
                            mp_sgd_update, sgd_mom_update, sgd_update)

__all__ = ["FORMULAS", "multi_tensor_update", "multi_tensor_update_plain",
           "UpdateBuffers", "CHUNK"]

#: formula -> (kernel id, per-tensor function, states a tensor, constants)
FORMULAS = {
    "sgd": (0, sgd_update, 0, ()),
    "sgd_mom": (1, sgd_mom_update, 1, ("momentum",)),
    "mp_sgd": (2, mp_sgd_update, 1, ()),
    "mp_sgd_mom": (3, mp_sgd_mom_update, 2, ("momentum",)),
    "adam": (4, adam_update, 2, ("beta1", "beta2", "epsilon")),
    "mp_adam": (5, mp_adam_update, 3, ("beta1", "beta2", "epsilon")),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: elements of a tensor one block updates
CHUNK = 8192
#: pinned host slots of the lr/wd vector in flight at once
RING = 4
_lock = threading.Lock()


def _hyper(kw):
    """The formula's constants, each defaulted as in `ops/optimizer_ops.py`."""
    return {"momentum": kw.get("momentum", 0.0),
            "beta1": kw.get("beta1", 0.9), "beta2": kw.get("beta2", 0.999),
            "epsilon": kw.get("epsilon", 1e-8)}


def multi_tensor_update_plain(formula, weights, grads, states, lrs, wds,
                              rescale_grad=1.0, clip_gradient=-1.0, **hyper):
    """The plain version: one call of the formula's function of
    `ops/optimizer_ops.py` a tensor, in list order."""
    _, fn, _, names = FORMULAS[formula]
    consts = {k: v for k, v in _hyper(hyper).items() if k in names}
    for w, g, st, lr, wd in zip(weights, grads, states, lrs, wds):
        fn(w, g, *st, lr=lr, wd=wd, rescale_grad=rescale_grad,
           clip_gradient=clip_gradient, **consts)


def _check(formula, weights, grads, states):
    n_states = FORMULAS[formula][2]
    dev, dtype = weights[0].device, weights[0].dtype
    if dtype not in _DTYPES:
        raise MXNetError("multi_tensor_update: the kernel takes f32 or bf16 "
                         "weights, got %s" % dtype)
    for w, g, st in zip(weights, grads, states):
        if w.device != dev or g.device != dev or w.dtype != dtype \
                or g.dtype != dtype:
            raise MXNetError(
                "multi_tensor_update: every weight and gradient must be %s "
                "on %s; got a %s weight on %s with a %s gradient on %s"
                % (dtype, dev, w.dtype, w.device, g.dtype, g.device))
        if len(st) != n_states:
            raise MXNetError("multi_tensor_update: %s takes %d states a "
                             "tensor, got %d" % (formula, n_states, len(st)))
        for t in (w, g) + tuple(st):
            if not t.is_contiguous() or t.numel() != w.numel():
                raise MXNetError("multi_tensor_update: tensors must be "
                                 "contiguous and of the weight's size")
        for s in st:
            if s.dtype != torch.float32 or s.device != dev:
                raise MXNetError("multi_tensor_update: states must be f32 "
                                 "on %s, got %s on %s"
                                 % (dev, s.dtype, s.device))


class UpdateBuffers:
    """The device side of one list's launches: the pointer table and chunk
    pairs (rebuilt when an address changes), the lr/wd vector and its
    pinned ring. One per (formula, dtype) group of an optimizer."""

    def __init__(self):
        self.key = None
        self.table = None
        self.chunks = None
        self.lrwd = None
        self._pinned = None
        self._events = [None] * RING
        self._slot = 0

    @staticmethod
    def pack(weights, grads, states):
        """(table, chunks) on the host: six int64s a tensor (weight,
        gradient, three states, size; absent states 0) and a (tensor,
        chunk) int32 pair for every CHUNK elements of every tensor."""
        rows, pairs = [], []
        for k, (w, g, st) in enumerate(zip(weights, grads, states)):
            ptrs = [s.data_ptr() for s in st] + [0] * (3 - len(st))
            rows.append([w.data_ptr(), g.data_ptr()] + ptrs + [w.numel()])
            pairs.extend((k, c) for c in range(-(-w.numel() // CHUNK)))
        return (torch.tensor(rows, dtype=torch.int64),
                torch.tensor(pairs, dtype=torch.int32).reshape(-1, 2))

    def prepare(self, formula, weights, grads, states, lrs, wds, stream):
        """Bring the table up to date, checking the list whenever it is
        rebuilt, and queue the copy of this call's lr/wd vector on
        ``stream``."""
        dev = weights[0].device
        key = (formula,) + tuple(
            t.data_ptr() for w, g, st in zip(weights, grads, states)
            for t in (w, g) + st) + tuple(w.numel() for w in weights)
        if key != self.key:
            _check(formula, weights, grads, states)
            table, chunks = self.pack(weights, grads, states)
            self.table = table.to(dev)
            self.chunks = chunks.to(dev)
            self.lrwd = torch.empty(2 * len(weights), dtype=torch.float32,
                                    device=dev)
            self._pinned = torch.empty((RING, 2 * len(weights)),
                                       dtype=torch.float32).pin_memory()
            self._events = [None] * RING
            self.key = key
        slot = self._slot
        self._slot = (slot + 1) % RING
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        vals = [v for pair in zip(lrs, wds) for v in pair]
        self._pinned[slot].copy_(torch.tensor(vals, dtype=torch.float32))
        self.lrwd.copy_(self._pinned[slot], non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        self._events[slot] = event


def _library():
    lib = _build.library("multi_tensor_update")
    with _lock:
        if lib.multi_tensor_update.argtypes is None:
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.multi_tensor_update.argtypes = \
                [i, i, vp, vp, i, vp, i] + [f] * 8 + [vp]
            lib.multi_tensor_update.restype = i
            lib.multi_tensor_update_error_name.argtypes = [i]
            lib.multi_tensor_update_error_name.restype = ctypes.c_char_p
    return lib


def multi_tensor_update(formula, weights, grads, states, lrs, wds,
                        rescale_grad=1.0, clip_gradient=-1.0, buffers=None,
                        **hyper):
    """Apply ``formula`` (a key of FORMULAS) in place to every tensor of
    ``weights`` from ``grads``, with ``states[k]`` the k-th tensor's
    states in the order of the formula's function in
    `ops/optimizer_ops.py`, ``lrs[k]`` and ``wds[k]`` its learning rate and
    weight decay; ``momentum``, ``beta1``, ``beta2`` and ``epsilon`` as the
    formula takes them. CPU tensors take the plain version; CUDA tensors
    one launch of U1, through ``buffers`` (an :class:`UpdateBuffers` kept
    by the caller from call to call; a new one when None)."""
    if formula not in FORMULAS:
        raise MXNetError("multi_tensor_update: unknown formula %r" % formula)
    if not weights:
        return
    states = [tuple(st) for st in states]
    if not len(weights) == len(grads) == len(states) == len(lrs) == len(wds):
        raise MXNetError("multi_tensor_update: lists of different lengths")
    dev = weights[0].device
    if dev.type == "cpu":
        multi_tensor_update_plain(formula, weights, grads, states, lrs, wds,
                                  rescale_grad, clip_gradient, **hyper)
        return
    if dev.type != "cuda":
        raise MXNetError("multi_tensor_update: no kernel for device %s" % dev)
    h = _hyper(hyper)
    clip = clip_gradient if clip_gradient is not None and clip_gradient > 0 \
        else -1.0
    buffers = buffers if buffers is not None else UpdateBuffers()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        buffers.prepare(formula, weights, grads, states, lrs, wds, stream)
        err = lib.multi_tensor_update(
            FORMULAS[formula][0], _DTYPES[weights[0].dtype],
            buffers.table.data_ptr(), buffers.chunks.data_ptr(),
            buffers.chunks.shape[0], buffers.lrwd.data_ptr(), CHUNK,
            rescale_grad, clip, h["momentum"], h["beta1"], 1.0 - h["beta1"],
            h["beta2"], 1.0 - h["beta2"], h["epsilon"], stream.cuda_stream)
    if err:
        raise MXNetError("multi_tensor_update kernel launch failed: %s (%d)"
                         % (lib.multi_tensor_update_error_name(err).decode(),
                            err))
    increment_version([t for w, st in zip(weights, states)
                       for t in (w,) + st])
    count(multi_tensor_update)


#: calls that launched the CUDA kernel (the plain version does not count)
multi_tensor_update.launches = 0
