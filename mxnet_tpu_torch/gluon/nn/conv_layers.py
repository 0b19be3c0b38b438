"""Gluon convolution and pooling layers, 1-D and 2-D.

Counterpart of `mxnet_tpu/gluon/nn/conv_layers.py` (reference
`python/mxnet/gluon/nn/conv_layers.py`): ``Conv1D`` and ``Conv2D`` (over
``_Conv``; channel-last weights are O,k...,I; an optional ``activation``
child, named as in the JAX package), ``MaxPool1D``/``2D``,
``AvgPool1D``/``2D``, ``GlobalMaxPool1D``/``2D`` and
``GlobalAvgPool1D``/``2D`` (over ``_Pooling``). The 3-D layers, the
transposed convolutions and ``ReflectionPad2D`` are not ported yet
(ROADMAP A.7).
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "MaxPool1D", "MaxPool2D", "AvgPool1D",
           "AvgPool2D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalAvgPool1D", "GlobalAvgPool2D"]


def _to_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channel_last = bool(layout) and layout[-1] == "C"
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if self._channel_last:
                wshape = (channels,) + tuple(kernel_size) + \
                    (in_channels // groups,)
            else:
                wshape = (channels, in_channels // groups) + \
                    tuple(kernel_size)
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_shapes(self, x):
        in_c = x.shape[-1] if self._channel_last else x.shape[1]
        w = list(self.weight.shape)
        iaxis = len(w) - 1 if self._channel_last else 1
        if w[iaxis] == 0:
            w[iaxis] = in_c // self._kwargs["num_group"]
        self.weight.shape = tuple(w)

    def hybrid_forward(self, F, x, weight, bias=None):
        args = (x, weight) if bias is None else (x, weight, bias)
        out = F.Convolution(*args, **self._kwargs)
        return out if self.act is None else self.act._forward_impl(out)

    def _alias(self):
        return "conv"


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 1),
                         _to_tuple(strides, 1), _to_tuple(padding, 1),
                         _to_tuple(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 2),
                         _to_tuple(strides, 2), _to_tuple(padding, 2),
                         _to_tuple(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, layout=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else strides,
            "pad": padding, "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if layout is not None:
            self._kwargs["layout"] = layout
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 1),
                         None if strides is None else _to_tuple(strides, 1),
                         _to_tuple(padding, 1), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 2),
                         None if strides is None else _to_tuple(strides, 2),
                         _to_tuple(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_to_tuple(pool_size, 1),
                         None if strides is None else _to_tuple(strides, 1),
                         _to_tuple(padding, 1), ceil_mode, False, "avg",
                         count_include_pad, layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_to_tuple(pool_size, 2),
                         None if strides is None else _to_tuple(strides, 2),
                         _to_tuple(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, layout=layout, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max",
                         layout=layout, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, **kwargs)
