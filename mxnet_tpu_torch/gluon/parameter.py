"""Gluon Parameter and ParameterDict.

Counterpart of `mxnet_tpu/gluon/parameter.py` (reference
`python/mxnet/gluon/parameter.py`), cut to what a Gluon net needs to be
built, initialised, trained, run eagerly and traced to a Symbol:
deferred initialisation (a parameter whose shape has unknown dimensions
waits for the first forward), ``data``, ``set_data`` (a copy into the
existing tensor, so a hybridized block's graph reads the new value),
the gradient buffer (``grad``, ``list_grad``, ``zero_grad``, the
``grad_req`` setter), ``cast``, ``var()`` and the prefixed
``ParameterDict`` (with ``zero_grad`` and ``setattr``). Unless its
``grad_req`` is ``null``, a parameter's tensor is a leaf of the autograd
tape whose gradient lands in its buffer (`autograd.mark_variables`); the
buffer is made with the data, in its dtype, and again by ``cast``. A
parameter lives on one device: the context ``initialize`` is given,
else that of the enclosing ``with ctx:`` scope, else ``gpu(0)``; without
that CUDA device it raises, as ``Module`` does. ``Constant`` is a
parameter with a fixed value and no gradient. ``ParameterDict.save`` /
``load`` read and write the ``.params`` container of either package
(names with a prefix stripped or restored, ``arg:``/``aux:`` tags
dropped on load); a loaded value fills an uninitialised parameter on the
given context (else the deferred one's, else the enclosing scope's, else
``gpu(0)``) or is copied into an initialised one, cast to the
parameter's dtype. ``reset_ctx`` moves a parameter to another device.
Multi-device contexts are not ported (ROADMAP A.10).
"""
from __future__ import annotations

import warnings
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, torch_dtype
from ..context import Context, cpu, gpu, scope_context
from .. import initializer as init_mod
from ..ndarray.ndarray import NDArray, array as nd_array, zeros as nd_zeros

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization."""


def _one_context(ctx):
    """The enclosing ``with ctx:`` scope's context by default, else
    gpu(0); a list must name one device. Checks that the device
    exists."""
    if ctx is None:
        ctx = scope_context() or gpu(0)
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError("a Parameter lives on one device in the port; "
                             "got %d contexts" % len(ctx))
        ctx = ctx[0]
    if not isinstance(ctx, Context):
        raise MXNetError("ctx must be a Context, got %r" % (ctx,))
    ctx.torch_device()      # no such CUDA device: raise here
    return ctx


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self._var = None
        self._data = None
        self._grad = None
        self._ctx = None
        self._deferred_init = ()
        self._differentiable = differentiable
        self._grad_req = None
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init
        self.allow_deferred_init = allow_deferred_init

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """``write``, ``add`` or ``null`` (always ``null`` for a parameter
        that is not differentiable). Going to ``null`` drops the gradient
        buffer and takes the data off the tape; leaving it makes a new
        zero buffer."""
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be one of 'write', 'add' or "
                             "'null', but got %r" % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null" and self._grad is not None:
            self._grad = None
            self._data = self._data.detach()
        elif self._data is not None:
            self._init_grad()

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is not None and not (
                len(self._shape) == len(new_shape)
                and all(j in (0, i) for i, j in zip(new_shape, self._shape))):
            raise MXNetError("Expected shape %s is incompatible with given "
                             "shape %s." % (new_shape, self._shape))
        self._shape = tuple(new_shape)

    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise RuntimeError("Parameter '%s' has not been initialized"
                           % self.name)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the parameter on ``ctx`` (by default the enclosing ``with
        ctx:`` scope's, else gpu(0)) by ``init``,
        else its own ``init``, else ``default_init``; a shape with unknown
        dimensions defers this to the first forward."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            warnings.warn("Parameter '%s' is already initialized, ignoring. "
                          "Set force_reinit=True to re-initialize."
                          % self.name, stacklevel=2)
            return
        ctx = _one_context(ctx)
        self._deferred_init = (init, ctx, default_init, None)
        if self._shape is None or np.prod(self._shape) <= 0:
            if self.allow_deferred_init:
                return
            raise ValueError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape: %s." % (self.name,
                                                         self._shape))
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if self._shape is None or np.prod(self._shape) <= 0:
            raise MXNetError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape: %s." % (self.name,
                                                         self._shape))
        if data is None:
            data = nd_zeros(self._shape, ctx=ctx, dtype=self.dtype)
            effective = init if init is not None \
                else (self.init or default_init)
            init_mod.create(effective)(init_mod.InitDesc(self.name), data)
        self._data = data
        self._ctx = ctx
        self._init_grad()

    def _init_grad(self):
        """A zero gradient buffer of the data's shape and dtype, and the
        data made a leaf of the tape whose gradient lands in it (no buffer
        for ``grad_req`` null)."""
        if self.grad_req == "null":
            self._grad = None
            return
        self._grad = NDArray(torch.zeros_like(self._data.data,
                                              requires_grad=False),
                             self._ctx)
        autograd.mark_variables([self._data], [self._grad], self.grad_req)

    def set_data(self, data):
        """Copy ``data`` in; before a deferred initialisation finishes it
        becomes the initial value."""
        self.shape = data.shape
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("Parameter '%s' has not been initialized"
                                 % self.name)
            init, ctx, default_init, _ = self._deferred_init
            self._deferred_init = (init, ctx, default_init,
                                   nd_array(data, ctx=ctx,
                                            dtype=self.dtype))
            self._finish_deferred_init()
            return
        self._data[:] = data

    def _load_init(self, data, ctx):
        """Take a loaded value (an NDArray): its shape must agree with the
        known dimensions; it is cast to this parameter's dtype, and fills
        the parameter on ``ctx`` (see the module docstring) or is copied
        into the initialised one."""
        if self.shape:
            if len(self.shape) != len(data.shape) or any(
                    d not in (0, e) for d, e in zip(self.shape, data.shape)):
                raise MXNetError(
                    "Failed loading Parameter '%s' from saved params: "
                    "shape incompatibility, expected %s vs saved %s"
                    % (self.name, self.shape, data.shape))
        self.shape = data.shape
        tensor = data.data.detach()
        dt = torch_dtype(self.dtype)
        if self._data is not None:
            with torch.no_grad():
                self._data.data.copy_(tensor.to(dt))
            self._data._wrote()
            return
        if ctx is None and self._deferred_init:
            ctx = self._deferred_init[1]
        ctx = _one_context(ctx)
        self._deferred_init = ()
        self._data = NDArray(tensor.to(device=ctx.torch_device(), dtype=dt,
                                       copy=True), ctx)
        self._ctx = ctx
        self._init_grad()

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def list_data(self):
        self._check_initialized()
        return [self._data]

    def list_ctx(self):
        """The parameter's context as a one-element list (the deferred
        one before a deferred initialisation finishes)."""
        if self._data is None:
            if self._deferred_init:
                return [self._deferred_init[1]]
            raise RuntimeError("Parameter '%s' has not been initialized"
                               % self.name)
        return [self._ctx]

    def reset_ctx(self, ctx):
        """Move the data (and a new zero gradient buffer) to ``ctx``; a
        deferred parameter will initialise there."""
        ctx = _one_context(ctx)
        if self._data is not None:
            self._data = NDArray(self._data.data.detach().to(
                ctx.torch_device(), copy=True), ctx)
            self._ctx = ctx
            self._init_grad()
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)

    def grad(self, ctx=None):
        """The gradient buffer; raises for ``grad_req`` null."""
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        self._check_initialized()
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient buffer to 0 in place."""
        if self._grad is not None:
            with torch.no_grad():
                self._grad.data.zero_()

    def cast(self, dtype):
        """Hold the parameter, and its gradient buffer, in ``dtype`` from
        now on (new tensors where the dtype changes)."""
        self.dtype = dtype
        self._var = None
        if self._data is None:
            return
        dt = torch_dtype(dtype)
        self._data = NDArray(self._data.data.detach().to(dt), self._ctx)
        if self._grad is not None:
            self._grad = NDArray(self._grad.data.to(dt), self._ctx)
            autograd.mark_variables([self._data], [self._grad],
                                    self.grad_req)

    def var(self):
        """The Symbol variable of this parameter (its name, shape, dtype,
        multipliers and initializer as attributes)."""
        from .. import symbol
        if self._var is None:
            self._var = symbol.var(self.name, shape=self.shape,
                                   dtype=self.dtype, lr_mult=self.lr_mult,
                                   wd_mult=self.wd_mult, init=self.init)
        return self._var

class Constant(Parameter):
    """A parameter that holds ``value`` (an NDArray, or anything
    ``nd.array`` takes) and takes no gradient."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd_array(value)
        self.value = value

        class Init(init_mod.Initializer):
            def _init_weight(self, _, arr):
                value.copyto(arr)
        init_name = "Constant_{}_{}".format(name, id(self))
        init_mod._INIT_REGISTRY[init_name.lower()] = Init
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=init_name)


class ParameterDict:
    """Parameters by name, with prefix namespacing (reference
    ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` when it
        does not exist; an existing one must agree with them (a 0 in a
        shape is a dimension still unknown)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None and len(v) == len(existing) \
                    and all(a == b or a * b == 0 for a, b in zip(v, existing)):
                param._shape = tuple(max(a, b) for a, b in zip(v, existing))
            elif k == "dtype" and np.dtype(v) == np.dtype(existing):
                continue
            elif v is not None and str(v) != str(existing):
                raise MXNetError(
                    "Cannot retrieve Parameter '%s' because desired "
                    "attribute does not match with stored for attribute "
                    "'%s': desired '%s' vs stored '%s'."
                    % (name, k, v, existing))
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("Cannot update self with other because they "
                                 "have different Parameters with the same "
                                 "name '%s'" % k)
            self._params[k] = v

    def get_constant(self, name, value=None):
        """The constant ``prefix + name``, made from ``value`` when it
        does not exist yet."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '%s'. Please specify "
                               "value if you want to create a new constant."
                               % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for param in self.values():
            param.initialize(None, ctx, init, force_reinit=force_reinit)

    def reset_ctx(self, ctx):
        for param in self.values():
            param.reset_ctx(ctx)

    def save(self, filename, strip_prefix=""):
        """Write every parameter's data to ``filename`` (the ``.params``
        container), named without ``strip_prefix``."""
        from ..ndarray.utils import save as nd_save
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with it"
                    % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load ``filename`` into these parameters, each saved name (an
        ``arg:``/``aux:`` tag dropped) with ``restore_prefix`` put back."""
        from ..ndarray.utils import load as nd_load
        for name in self.keys():
            if not name.startswith(restore_prefix):
                raise MXNetError("restore_prefix is '%s' but Parameter name "
                                 "'%s' does not start with it"
                                 % (restore_prefix, name))
        lprefix = len(restore_prefix)
        loaded = nd_load(filename, ctx=cpu())   # read on the host
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter '%s' is missing in file '%s'"
                                     % (name[lprefix:], filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in ParameterDict" % (name[lprefix:], filename))
                continue
            self[name]._load_init(value, ctx)

    def zero_grad(self):
        for param in self.values():
            param.zero_grad()

    def setattr(self, name, value):
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of every
        parameter."""
        for param in self.values():
            setattr(param, name, value)
