"""Gluon basic layers (the ones ResNet uses).

Counterpart of `mxnet_tpu/gluon/nn/basic_layers.py` (reference
`python/mxnet/gluon/nn/basic_layers.py`): ``HybridSequential``,
``Dense``, ``Activation``, ``BatchNorm`` (moving statistics as
parameters that take no gradient) and ``Flatten``. ``Sequential``,
``Dropout``, ``Embedding``, ``InstanceNorm``, ``LayerNorm``, the lambdas
and the other activations are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Activation", "BatchNorm",
           "Flatten"]


def _first(out):
    """The first output of a multi-output op (an NDArray list or a
    Symbol with several outputs)."""
    if isinstance(out, (list, tuple)):
        return out[0]
    return out[0] if len(out) > 1 else out


class HybridSequential(HybridBlock):
    """Children run in the order they were added."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        raise RuntimeError("HybridSequential dispatches via _forward_impl")

    def _forward_impl(self, x):
        for block in self._children.values():
            x = block._forward_impl(x)
        return x

    _symbolic_forward = _forward_impl


class Dense(HybridBlock):
    """``FullyConnected``."""

    def __init__(self, units, use_bias=True, flatten=True,
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

    def _infer_shapes(self, x):
        if self.weight.shape[1] == 0:
            in_units = int(np.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        args = (x, weight) if bias is None else (x, weight, bias)
        return F.FullyConnected(*args, no_bias=bias is None,
                                num_hidden=self._units, flatten=self._flatten)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

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
