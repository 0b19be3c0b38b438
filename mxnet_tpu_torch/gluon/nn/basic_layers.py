"""Gluon basic layers.

Counterpart of `mxnet_tpu/gluon/nn/basic_layers.py` (reference
`python/mxnet/gluon/nn/basic_layers.py`): ``Sequential``,
``HybridSequential``, ``Dense`` (with an optional ``activation`` child,
named as in the JAX package), ``Activation``, ``Dropout``, ``BatchNorm``
(moving statistics as parameters that take no gradient), ``Embedding``,
``InstanceNorm``, ``LayerNorm``, ``Flatten``, ``Lambda``,
``HybridLambda`` and the activations of the reference's
`gluon/nn/activations.py`, merged here as in the JAX package:
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU`` and ``Swish``.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "Flatten", "Lambda",
           "HybridLambda", "Activation", "LeakyReLU", "PReLU", "ELU", "SELU",
           "Swish"]


def _first(out):
    """The first output of a multi-output op (an NDArray list or a
    Symbol with several outputs)."""
    if isinstance(out, (list, tuple)):
        return out[0]
    return out[0] if len(out) > 1 else out


class _Stack:
    """``add``, indexing (a slice is a new container of the same kind)
    and ``len`` of the sequential containers."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)


class Sequential(_Stack, Block):
    """Children called in the order they were added."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            warnings.warn("All children of this Sequential layer are "
                          "HybridBlocks. Consider using HybridSequential "
                          "for the best performance.", stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(_Stack, HybridBlock):
    """Children run in the order they were added."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        raise RuntimeError("HybridSequential dispatches via _forward_impl")

    def _forward_impl(self, x):
        for block in self._children.values():
            x = block._forward_impl(x)
        return x

    _symbolic_forward = _forward_impl


class Dense(HybridBlock):
    """``FullyConnected``, then ``activation`` if one is given."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=np.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          init=weight_initializer,
                                          dtype=dtype,
                                          allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=bias_initializer, dtype=dtype,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_shapes(self, x):
        if self.weight.shape[1] == 0:
            in_units = int(np.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        # no_bias only where it is true, so the traced graph's attributes
        # are the JAX package's
        extra = {"no_bias": True} if bias is None else {}
        args = (x, weight) if bias is None else (x, weight, bias)
        out = F.FullyConnected(*args, num_hidden=self._units,
                               flatten=self._flatten, **extra)
        return out if self.act is None else self.act._forward_impl(out)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """``Dropout`` at ``rate`` in training; the identity otherwise."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return _first(F.Dropout(x, p=self._rate, axes=self._axes))


class BatchNorm(HybridBlock):
    """The moving mean and variance are parameters with ``grad_req``
    null; in a traced graph they are the op's auxiliary states."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        shape = (in_channels,)
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null", shape=shape,
            init=gamma_initializer, allow_deferred_init=True,
            differentiable=scale)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null", shape=shape,
            init=beta_initializer, allow_deferred_init=True,
            differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=shape,
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=shape,
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def _infer_shapes(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            if not p.shape or p.shape[0] == 0:
                p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return _first(F.BatchNorm(x, gamma, beta, running_mean, running_var,
                                  name="fwd", **self._kwargs))


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Embedding(HybridBlock):
    """Rows of a (``input_dim``, ``output_dim``) weight by index."""

    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      init=weight_initializer, dtype=dtype,
                                      allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class _NormScaleShift(HybridBlock):
    """``gamma`` and ``beta`` of the size of ``axis`` (taking no gradient
    without ``scale`` / ``center``), their size read from the data at
    deferred initialisation."""

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def _infer_shapes(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            if not p.shape or p.shape[0] == 0:
                p.shape = (c,)


class InstanceNorm(_NormScaleShift):
    """``InstanceNorm`` over the spatial axes of each sample and channel;
    ``axis`` names the channel axis (swapped to axis 1 around the op)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = F.swapaxes(x, dim1=1, dim2=self._axis)
        return F.swapaxes(F.InstanceNorm(x, gamma, beta, eps=self._epsilon),
                          dim1=1, dim2=self._axis)


class LayerNorm(_NormScaleShift):
    """``LayerNorm`` over ``axis``, with ``gamma`` and ``beta`` of that
    axis's size (taking no gradient without ``scale`` / ``center``)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix=prefix,
                         params=params)

    def hybrid_forward(self, F, data, gamma, beta):
        return _first(F.LayerNorm(data, gamma, beta, axis=self._axis,
                                  eps=self._epsilon))


class Lambda(Block):
    """A block over ``function``: a callable, or the name of an ``nd``
    function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            if not hasattr(nd, function):
                raise ValueError("Function name %s is not found in ndarray."
                                 % function)
            self._func_impl = getattr(nd, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError("Unrecognized function in lambda: {}"
                             .format(function))

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """A hybrid block over ``function(F, x, *args)``, or the name of a
    function of ``F`` (``nd`` or ``sym``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if not isinstance(function, str) and not callable(function):
            raise ValueError("Unrecognized function in lambda: {}"
                             .format(function))
        self._function = function

    def hybrid_forward(self, F, x, *args):
        if isinstance(self._function, str):
            return getattr(F, self._function)(x, *args)
        return self._function(F, x, *args)


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise ValueError("Slope coefficient for LeakyReLU must be no "
                             "less than 0.")
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """``LeakyReLU`` with one learned slope ``alpha``."""

    def __init__(self, alpha_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
