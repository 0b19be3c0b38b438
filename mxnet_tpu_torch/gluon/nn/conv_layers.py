"""Gluon convolution and pooling layers.

Counterpart of `mxnet_tpu/gluon/nn/conv_layers.py` (reference
`python/mxnet/gluon/nn/conv_layers.py`): ``Conv1D``/``2D``/``3D`` and
``Conv1DTranspose``/``2D``/``3D`` (over ``_Conv``; channel-last
convolution weights are O,k...,I, transposed-convolution weights are
(in, out/groups, k...), channel-first only, with ``output_padding`` as
the op's ``adj``; an optional ``activation`` child, named as in the JAX
package), the max, average and global pools in 1-3 dimensions (over
``_Pooling``) and ``ReflectionPad2D``.
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _to_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._op_name = op_name
            self._channel_last = bool(layout) and layout[-1] == "C"
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Deconvolution":
                if self._channel_last:
                    raise ValueError("channel-last layout is not supported "
                                     "for transposed convolution")
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size)
            elif self._channel_last:
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
        if self._op_name == "Deconvolution":
            if w[0] == 0:
                w[0] = in_c
        else:
            iaxis = len(w) - 1 if self._channel_last else 1
            if w[iaxis] == 0:
                w[iaxis] = in_c // self._kwargs["num_group"]
        self.weight.shape = tuple(w)

    def hybrid_forward(self, F, x, weight, bias=None):
        args = (x, weight) if bias is None else (x, weight, bias)
        out = getattr(F, self._op_name)(*args, **self._kwargs)
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


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 3),
                         _to_tuple(strides, 3), _to_tuple(padding, 3),
                         _to_tuple(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    """A transposed convolution of ``nd`` spatial axes: the
    ``Deconvolution`` op with ``output_padding`` as its ``adj``."""

    def __init__(self, nd, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer, in_channels,
                 **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, nd),
                         _to_tuple(strides, nd), _to_tuple(padding, nd),
                         _to_tuple(dilation, nd), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_to_tuple(output_padding, nd), **kwargs)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(1, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(2, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(3, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         activation, use_bias, weight_initializer,
                         bias_initializer, in_channels, **kwargs)


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


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 3),
                         None if strides is None else _to_tuple(strides, 3),
                         _to_tuple(padding, 3), ceil_mode, False, "max",
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


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_to_tuple(pool_size, 3),
                         None if strides is None else _to_tuple(strides, 3),
                         _to_tuple(padding, 3), ceil_mode, False, "avg",
                         count_include_pad, layout=layout, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max",
                         layout=layout, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the two trailing axes of an NCHW input:
    ``padding`` pixels on each side, or the ``Pad`` op's eight-entry
    ``pad_width``."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, (int, np.integer)):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
