"""Device contexts.

Counterpart of `mxnet_tpu/context.py`: a :class:`Context` names a device
as the reference does (``cpu(i)``, ``gpu(i)``, ``cpu_pinned(i)``, and the
JAX package's ``tpu(i)``) and resolves to a ``torch.device``. ``gpu(i)``
is ``cuda:i``, and so is ``tpu(i)``: the JAX package's ``tpu`` is its
accelerator, which here is the card. ``cpu_pinned`` is the CPU. There is
no fallback: an accelerator context on a host without that CUDA device
raises when it is resolved, so a model the caller placed on the card
never runs on the CPU unasked. :func:`scope_context` is the context of
the innermost ``with ctx:`` scope, or None outside every scope.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "scope_context", "num_gpus", "num_tpus"]


class Context:
    """Device context, usable as a ``with ctx:`` scope like the reference."""

    # reference devtype ids (include/mxnet/base.h): cpu=1, gpu=2,
    # cpu_pinned=3; tpu=6 is the JAX package's
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 6: "tpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = scope_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    def empty_cache(self):
        """Release the cached blocks of PyTorch's allocator on this
        context's CUDA device (the JAX package's is a no-op: XLA keeps its
        own pools). Nothing to do on the CPU."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return
        with torch.cuda.device(self.torch_device()):
            torch.cuda.empty_cache()

    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context; raises for a GPU context
        whose CUDA device is not present."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        n = num_gpus()
        if self.device_id >= n:
            raise MXNetError(
                "%s needs CUDA device %d, but this host has %d; pass "
                "ctx=cpu() to run on the CPU" % (self, self.device_id, n))
        return torch.device("cuda", self.device_id)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def tpu(device_id=0):
    """The JAX package's accelerator context: ``cuda:i`` here, as
    ``gpu(i)``."""
    return Context("tpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


num_tpus = num_gpus


def current_context():
    """The context of the innermost enclosing ``with ctx:``, else
    ``cpu(0)``."""
    return scope_context() or Context("cpu", 0)


def scope_context():
    """The context of the innermost enclosing ``with ctx:``, else None."""
    return getattr(Context._default_ctx, "value", None)
