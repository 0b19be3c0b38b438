"""Weight initializers.

Counterpart of `mxnet_tpu/initializer.py` (reference
`python/mxnet/initializer.py`): ``InitDesc``, the name dispatch of
``Initializer.__call__``, and ``Zero``, ``One``, ``Constant``,
``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu``,
``Bilinear``, ``LSTMBias``, ``Mixed`` (initializers by name pattern) and
``Load`` (values from a dict of arrays), with ``register``/``create``.
Values are drawn with numpy's global generator in the JAX package's
order and cast to the array's dtype on the host, then copied to the
array's device, so one ``np.random`` seed gives bit-identical
parameters in both packages.
"""
from __future__ import annotations

import json

import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Name + attrs descriptor (reference initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be str or InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "") \
            if isinstance(desc, InitDesc) else ""
        if init:
            klass, kwargs = json.loads(init)
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("min"):
            self._init_zero(desc, arr)
        elif name.endswith("max"):
            self._init_one(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("parameters"):
            # the RNN op's flat weight+bias blob is 1-D, so shape-aware
            # initializers (Xavier) cannot apply: a small uniform, the
            # reference's classic 0.07 RNN default
            if len(arr.shape) >= 2:
                self._init_weight(desc, arr)
            else:
                self._set(arr, np.random.uniform(-0.07, 0.07, arr.shape))
        elif name.endswith("state") or name.endswith("state_cell"):
            # RNN begin states default to zeros
            self._init_zero(desc, arr)
        else:
            raise ValueError(
                "Unknown initialization pattern for %s." % desc)

    @staticmethod
    def _set(arr, np_value):
        if arr.data.dtype == torch.bfloat16:   # no numpy bf16: through f32
            arr[:] = torch.from_numpy(np.asarray(np_value, np.float32)) \
                .to(torch.bfloat16)
        else:
            arr[:] = np.asarray(np_value).astype(arr.dtype)

    @staticmethod
    def _init_zero(_, arr):
        arr[:] = 0.0

    @staticmethod
    def _init_one(_, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._set(arr, np.random.uniform(-self.scale, self.scale, arr.shape))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._set(arr, np.random.normal(0, self.sigma, arr.shape))


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal factor (numpy's SVD) of a uniform
    or normal (``rand_type``) draw of the weight's (out, in) shape."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        self._set(arr, self.scale * res.reshape(arr.shape))


@register
class Xavier(Initializer):
    """Reference initializer.py Xavier (uniform/gaussian; avg/in/out)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factors = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                   "out": fan_out}
        if self.factor_type not in factors:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factors[self.factor_type])
        if self.rnd_type == "uniform":
            self._set(arr, np.random.uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            self._set(arr, np.random.normal(0, scale, shape))
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """Gaussian ``Xavier`` with magnitude ``2 / (1 + slope**2)`` (He et
    al.'s PReLU initialisation)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling weights for a ``Deconvolution`` (every filter
    pair the same 2-D kernel of the last two axes)."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._set(arr, weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (gate order i, f, g, o) at
    ``forget_bias`` (reference initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)


@register
class Mixed:
    """The first initializer whose pattern (a regular expression matched
    at the start of the name) matches."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter name %s did not match any pattern"
                         % name)


@register
class Load:
    """Values from ``param`` (names may carry the ``arg:``/``aux:``
    prefixes of a saved file), else ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {(name[4:] if name.startswith(("arg:", "aux:"))
                       else name): arr for name, arr in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name not in self.param:
            if self.default_init is None:
                raise MXNetError("Cannot Initialize parameter %s" % name)
            self.default_init(name, arr)
            return
        src = self.param[name]
        if tuple(src.shape) != tuple(arr.shape):
            raise MXNetError("Parameter %s cannot be initialized from "
                             "loading. Shape mismatch, target %s vs loaded "
                             "%s" % (name, str(arr.shape), str(src.shape)))
        arr[:] = src.asnumpy() if hasattr(src, "asnumpy") else src


# reference registers these under plural/alternate names
_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One
_INIT_REGISTRY["gaussian"] = Normal


def create(name, **kwargs):
    """The initializer registered as ``name``; an initializer object or
    any callable ``init(desc, arr)`` (``Mixed``, ``Load``) as it is."""
    if not isinstance(name, str):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)
