"""Parameter-shape inference for symbolic binding.

Counterpart of `mxnet_tpu/symbol/infer.py`: output shapes come from
running each op on ``meta`` tensors (`symbol.py`); this module fills the
shapes of *parameter* inputs (weights, biases, RNN states) from the data
shape and the op's attributes.

Each filler: fn(params, in_shapes) -> in_shapes with None entries filled.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..ops.nn import _attr_bool, rnn_param_size

_FILLERS = {}


def filler(*names):
    def deco(fn):
        for n in names:
            _FILLERS[n] = fn
        return fn
    return deco


def fill_param_shapes(op_name, params, in_shapes):
    if all(s is not None for s in in_shapes):
        return in_shapes
    fn = _FILLERS.get(op_name)
    if fn is None:
        # default: unknown inputs take the first known input's shape
        known = next((s for s in in_shapes if s is not None), None)
        if known is None:
            raise MXNetError("cannot infer shapes for op %s" % op_name)
        return [known if s is None else s for s in in_shapes]
    if in_shapes[0] is None:
        raise MXNetError("cannot infer shapes for op %s: data shape "
                         "unknown" % op_name)
    return fn(params, list(in_shapes))


@filler("FullyConnected")
def _fc(params, shapes):
    data = shapes[0]
    nh = params["num_hidden"]
    d = int(np.prod(data[1:])) if params.get("flatten", True) else data[-1]
    if shapes[1] is None:
        shapes[1] = (nh, d)
    if len(shapes) > 2 and shapes[2] is None:
        shapes[2] = (nh,)
    return shapes


@filler("Convolution")
def _conv(params, shapes):
    """Channel-first weights are OI<spatial>, channel-last O<spatial>I."""
    data = shapes[0]
    nf = params["num_filter"]
    g = params.get("num_group", 1)
    kernel = tuple(params["kernel"])
    layout = params.get("layout") or ""
    if shapes[1] is None:
        if layout.endswith("C") and len(layout) > 2:
            shapes[1] = (nf,) + kernel + (data[-1] // g,)
        else:
            shapes[1] = (nf, data[1] // g) + kernel
    if len(shapes) > 2 and shapes[2] is None:
        shapes[2] = (nf,)
    return shapes


@filler("Deconvolution")
def _deconv(params, shapes):
    """Weights (in, out/groups) + kernel."""
    nf = params["num_filter"]
    if shapes[1] is None:
        shapes[1] = (shapes[0][1], nf // params.get("num_group", 1)) + \
            tuple(params["kernel"])
    if len(shapes) > 2 and shapes[2] is None:
        shapes[2] = (nf,)
    return shapes


@filler("BatchNorm", "BatchNorm_v1")
def _bn(params, shapes):
    """gamma, beta and the two moving statistics: one value per channel."""
    c = shapes[0][params.get("axis", 1)]
    for i in range(1, len(shapes)):
        if shapes[i] is None:
            shapes[i] = (c,)
    return shapes


@filler("LayerNorm")
def _ln(params, shapes):
    """gamma and beta: one value along the normalised axis."""
    c = shapes[0][int(params.get("axis", -1))]
    for i in (1, 2):
        if shapes[i] is None:
            shapes[i] = (c,)
    return shapes


@filler("InstanceNorm")
def _in(params, shapes):
    """gamma and beta: one value per channel (axis 1)."""
    for i in (1, 2):
        if shapes[i] is None:
            shapes[i] = (shapes[0][1],)
    return shapes


@filler("LeakyReLU")
def _prelu(params, shapes):
    """``prelu``'s gamma: one slope per channel (axis 1)."""
    if len(shapes) > 1 and shapes[1] is None:
        data = shapes[0]
        shapes[1] = (data[1] if len(data) > 1 else data[0],)
    return shapes


@filler("Embedding")
def _emb(params, shapes):
    if shapes[1] is None:
        shapes[1] = (params["input_dim"], params["output_dim"])
    return shapes


@filler("SoftmaxOutput", "Softmax", "SVMOutput")
def _softmax_output(params, shapes):
    """The label: the data shape without its class axis (axis 1 with
    ``multi_output``, else the last)."""
    data = shapes[0]
    if shapes[1] is None:
        if _attr_bool(params, "multi_output"):
            shapes[1] = (data[0],) + tuple(data[2:])
        else:
            shapes[1] = tuple(data[:-1]) if len(data) >= 2 else tuple(data)
    return shapes


@filler("LinearRegressionOutput", "LogisticRegressionOutput",
        "MAERegressionOutput")
def _regression_output(params, shapes):
    """The label: the data's shape."""
    if shapes[1] is None:
        shapes[1] = tuple(shapes[0])
    return shapes


@filler("RNN")
def _rnn(params, shapes):
    T, B, I = shapes[0]
    H = params["state_size"]
    L = params.get("num_layers", 1)
    bidir = params.get("bidirectional", False)
    d = 2 if bidir else 1
    if shapes[1] is None:
        shapes[1] = (rnn_param_size(L, I, H, bidir, params["mode"]),)
    if shapes[2] is None:
        shapes[2] = (L * d, B, H)
    if len(shapes) > 3 and shapes[3] is None:
        shapes[3] = (L * d, B, H)
    return shapes
