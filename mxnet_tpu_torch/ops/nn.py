"""Neural-network operators (the subset the port's slices use).

Counterpart of `mxnet_tpu/ops/nn.py`: ``FullyConnected``, ``softmax``,
``log_softmax``, ``SoftmaxActivation``, the ``SoftmaxOutput`` loss head,
``softmax_cross_entropy``, the fused multi-layer ``RNN`` op with
its cuDNN flat parameter layout, ``Convolution``, ``BatchNorm``,
``Pooling`` and ``Activation`` in channel-first and channel-last layouts,
``LeakyReLU`` (``leaky``, ``elu``, ``selu``, ``prelu``, ``rrelu``),
``Dropout`` and ``LayerNorm``. ``Dropout`` and ``rrelu`` draw from the
op's generator only in training (``Dropout`` also under
``mode="always"``), so in predict mode they run inside a CUDA graph
capture.

An LSTM layer that needs a gradient runs ``FusedLSTM`` (the hand-written
training kernels K2/K3 on a CUDA tensor, their plain versions on the
CPU); otherwise it runs the inference kernel ``fused_lstm`` (K1) on a
CUDA tensor and a plain loop over time everywhere else (CPU, and
``meta`` tensors during shape inference). With ``MXNET_CONV1X1_PALLAS``
on, an NHWC stride-2 1x1 convolution takes its input gradient from K5
(`ops/conv_kernel.py`). The JAX package's TPU-only convolution rewrites
(space-to-depth, ``MXNET_CONV1X1_DOT``, ``MXNET_CONV1X1_S1DOT``,
``MXNET_CONV1X1_BWD``) and ``MXNET_POOL_SLICES`` are not ported.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .conv_kernel import conv1x1_s2_dgrad
from .lstm_kernel import FusedLSTM, fused_lstm
from .registry import register


@register("FullyConnected")
def _fully_connected(params, data, weight, *bias):
    """Reference nn/fully_connected-inl.h; ``flatten`` folds every axis
    after the first into the input width, else the op maps the last
    axis only."""
    flatten = params.get("flatten", True)
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    out = torch.matmul(x, weight.t())
    if not params.get("no_bias", False) and bias:
        out = out + bias[0]
    return (out,)


@register("softmax")
def _softmax(params, data):
    axis = params.get("axis", -1)
    t = params.get("temperature") or 1.0
    return (torch.softmax(data / t, dim=axis),)


@register("log_softmax")
def _log_softmax(params, data):
    """``log(softmax(data / temperature))`` along ``axis``, in the data
    dtype."""
    axis = params.get("axis", -1)
    t = params.get("temperature") or 1.0
    return (torch.log_softmax(data if t == 1.0 else data / t, dim=axis),)


# ---------------------------------------------------------------------------
# SoftmaxOutput (reference softmax_output-inl.h)
# ---------------------------------------------------------------------------
def _attr_num(params, key, default):
    """A numeric attribute; attributes of a graph read from JSON are
    strings."""
    try:
        return float(params.get(key, default))
    except (TypeError, ValueError):
        return default


def _attr_bool(params, key, default=False):
    v = params.get(key, default)
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes")
    return bool(v)


def _normalize_grad(grad, label, params):
    """A head's gradient scaled by ``grad_scale`` and divided as
    ``normalization`` says: by nothing (``null``), the batch (``batch``)
    or the count of labels other than ``ignore_label`` (``valid``)
    (`mxnet_tpu/ops/nn.py::_normalize_grad`)."""
    scale = _attr_num(params, "grad_scale", 1.0)
    norm = params.get("normalization", "null")
    if norm == "batch":
        scale = scale / label.shape[0]
    elif norm == "valid":
        ignore = _attr_num(params, "ignore_label", -1)
        valid = torch.clamp((label != ignore).sum(), min=1).to(grad.dtype)
        return grad * (scale / valid)
    return grad * scale


def _one_hot(label, out):
    """One-hot rows of ``label`` over ``out``'s last axis; labels outside
    [0, C) give a zero row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(out.shape[-1], device=out.device)
    return (label.long()[..., None] == classes).to(out.dtype)


def _softmax_output_grad(out, label, params):
    """(p - onehot(label)), masked and scaled as the attributes say
    (`mxnet_tpu/ops/nn.py::_so_grad`)."""
    grad = out - _one_hot(label, out)
    if _attr_bool(params, "use_ignore"):
        ignore = _attr_num(params, "ignore_label", -1)
        grad = grad * (label != ignore).to(out.dtype)[..., None]
    return _normalize_grad(grad, label, params)


def _output_head(forward, grad):
    """A loss head as a ``torch.autograd.Function``: ``forward(data)``
    forward, and ``grad(out, label, params)`` backward whatever the
    incoming gradient, as the reference's loss heads
    (`mxnet_tpu/ops/nn.py::_make_output_head`). The label takes no
    gradient. A gradient whose shape is not the data's (a label that
    broadcasts against the output) raises, as the JAX head's VJP does."""

    class _Head(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, params):
            out = forward(data)
            ctx.save_for_backward(out, label)
            ctx.params = params
            return out

        @staticmethod
        def backward(ctx, _):
            out, label = ctx.saved_tensors
            g = grad(out, label, ctx.params)
            if g.shape != out.shape:
                raise MXNetError(
                    "output head: the label of shape %s gives a gradient "
                    "of shape %s for an output of shape %s"
                    % (tuple(label.shape), tuple(g.shape), tuple(out.shape)))
            return g.to(out.dtype), None, None

    return _Head.apply


def _head_attrs(params):
    return {k: v for k, v in params.items() if not k.startswith("_")}


_softmax_head = _output_head(lambda x: torch.softmax(x, dim=-1),
                             _softmax_output_grad)


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(params, data, label):
    """Reference softmax_output-inl.h: forward softmax, backward (p - y)."""
    attrs = _head_attrs(params)
    head = _softmax_head
    if _attr_bool(params, "multi_output"):
        # data (N, C, d...) label (N, d...): softmax over axis 1
        perm = (0,) + tuple(range(2, data.dim())) + (1,)
        inv = (0, data.dim() - 1) + tuple(range(1, data.dim() - 1))
        return (head(data.permute(*perm), label, attrs).permute(*inv),)
    if data.dim() > 2:
        out = head(data.reshape(-1, data.shape[-1]), label.reshape(-1), attrs)
        return (out.reshape(data.shape),)
    return (head(data, label, attrs),)


def _svm_grad(out, label, params):
    """Reference svm_output-inl.h: the hinge loss's gradient with
    ``margin``, ``regularization_coefficient`` (C) and ``use_linear``
    (L1-SVM: -C*y*1{margin - y*f > 0}; L2-SVM: -2C*y*max(0, margin - y*f)),
    y = +1 for the label's class and -1 elsewhere."""
    margin = _attr_num(params, "margin", 1.0)
    coef = _attr_num(params, "regularization_coefficient", 1.0)
    sign = 2 * _one_hot(label, out) - 1
    viol = torch.clamp(margin - out * sign, min=0.0)
    if _attr_bool(params, "use_linear"):
        return -coef * sign * (viol > 0).to(out.dtype)
    return -2.0 * coef * sign * viol


def _regression_grad(out, label, params):
    """``out - label`` with numpy broadcasting, as the JAX heads take it
    (not the reference's ``grad_scale / num_output``)."""
    return out - label


def _register_head(name, forward, grad):
    """An output head over ``_output_head``; its gradient is then scaled
    as ``normalization`` and ``grad_scale`` say."""
    head = _output_head(forward, lambda o, l, p: _normalize_grad(
        grad(o, l, p), l, p))

    @register(name)
    def _op(params, data, label):
        return (head(data, label, _head_attrs(params)),)
    return _op


_register_head("LinearRegressionOutput", lambda x: x, _regression_grad)
_register_head("LogisticRegressionOutput", torch.sigmoid, _regression_grad)
_register_head("MAERegressionOutput", lambda x: x,
               lambda o, l, p: torch.sign(o - l))
_register_head("SVMOutput", lambda x: x, _svm_grad)


# ---------------------------------------------------------------------------
# CTCLoss (reference contrib/ctc_loss-inl.h)
# ---------------------------------------------------------------------------
def _ctc_label_lengths(label, pad):
    """Each row's count of entries before its first padding entry: a
    label ends at its first pad, as the reference's
    ``LabelTensorToPackedVector`` reads it."""
    L = label.shape[1]
    idx = torch.arange(L, device=label.device).expand_as(label)
    return torch.where(pad, idx, torch.full_like(idx, L)).amin(dim=1)


def _ctc_needed_frames(label, lab_len):
    """The fewest frames an alignment of each label needs: one a symbol,
    and one blank between two equal neighbours."""
    idx = torch.arange(1, label.shape[1], device=label.device)
    repeat = (label[:, 1:] == label[:, :-1]) & (idx < lab_len[:, None])
    return lab_len + repeat.sum(dim=1)


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def _ctc_loss(params, data, label, *lens):
    """Reference contrib/ctc_loss-inl.h: the per-sample CTC loss of
    ``data`` (T, B, C) against ``label`` (B, L), in the data's dtype. The
    blank is class 0 with labels padded by 0 (``blank_label="first"``) or
    class C-1 with labels padded by -1 (``"last"``); the optional inputs
    are ``data_lengths`` then ``label_lengths``, read under
    ``use_data_lengths`` / ``use_label_lengths``. Without label lengths a
    label ends at its first pad. The forward-backward is PyTorch's
    ``ctc_loss`` over ``log_softmax`` in f32, as the JAX op's scan is
    over its f32 ``log_softmax``; its gradient is right only through
    that ``log_softmax``. A label that no alignment of its frames can
    emit reads ``inf`` and gives no gradient.

    The lengths reach the host, so a program holding the op is not
    captured into a CUDA graph (`compiled.note_host_op`)."""
    T, B, C = data.shape
    if data.device.type == "meta":
        return (torch.empty(B, dtype=data.dtype, device="meta"),)
    from .. import compiled
    compiled.note_host_op("CTCLoss")
    blank_first = params.get("blank_label", "first") == "first"
    lab = label.long().to(data.device)
    lens = list(lens)
    data_len = torch.full((B,), T, dtype=torch.long, device=data.device)
    if _attr_bool(params, "use_data_lengths") and lens:
        data_len = lens.pop(0).long().to(data.device).clamp(0, T)
    if _attr_bool(params, "use_label_lengths") and lens:
        lab_len = lens.pop(0).long().to(data.device)
    else:
        lab_len = _ctc_label_lengths(lab, lab == 0 if blank_first
                                     else lab < 0)
    # the loss of a label that cannot fit its frames is reported as inf
    # below; zero_infinity keeps its NaN gradient out of the batch
    logp = torch.log_softmax(data.float(), dim=-1)
    loss = F.ctc_loss(logp, lab.clamp(min=0), data_len, lab_len,
                      blank=0 if blank_first else C - 1, reduction="none",
                      zero_infinity=True)
    infeasible = _ctc_needed_frames(lab, lab_len) > data_len
    loss = torch.where(infeasible, torch.full_like(loss, float("inf")), loss)
    return (loss.to(data.dtype),)


# ---------------------------------------------------------------------------
# Fused RNN (reference rnn-inl.h modes rnn_relu/rnn_tanh/lstm/gru)
# ---------------------------------------------------------------------------
def _rnn_nout(params):
    if not params.get("state_outputs", False):
        return 1
    return 3 if params["mode"] == "lstm" else 2


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Total flat parameter count, cuDNN layout (reference rnn-inl.h:106)."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        for _ in range(d):
            size += g * state_size * (in_sz + state_size)  # i2h + h2h weights
            size += 2 * g * state_size                      # i2h + h2h biases
    return size


def _unpack_rnn_params(flat, num_layers, input_size, state_size, bidir, mode):
    """Views into the flat vector, cuDNN layout: all weights (layer-major,
    direction-minor), then all biases."""
    g = _gates(mode)
    d = 2 if bidir else 1
    offset = 0

    def take(n, *shape):
        nonlocal offset
        v = flat[offset:offset + n].reshape(*shape)
        offset += n
        return v

    weights = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        for _ in range(d):
            w_i2h = take(g * state_size * in_sz, g * state_size, in_sz)
            w_h2h = take(g * state_size * state_size, g * state_size,
                         state_size)
            weights.append((w_i2h, w_h2h))
    biases = []
    for _ in range(num_layers * d):
        b_i2h = take(g * state_size, g * state_size)
        b_h2h = take(g * state_size, g * state_size)
        biases.append((b_i2h, b_h2h))
    return weights, biases


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rnn_cell_scan(mode, x_seq, h0, c0, w_i2h, w_h2h, b_i2h, b_h2h,
                   reverse=False):
    """One direction of one layer. x_seq (T,B,I) -> (T,B,H).

    An LSTM layer that needs a gradient goes through ``FusedLSTM``
    (K2 forward, K3 backward; their plain versions on the CPU); one that
    does not runs K1 on a CUDA tensor and the plain loop below
    elsewhere."""
    training = mode == "lstm" and _needs_grad(x_seq, h0, c0, w_i2h, w_h2h,
                                              b_i2h, b_h2h)
    if training or (mode == "lstm" and x_seq.is_cuda):
        xs = torch.flip(x_seq, (0,)) if reverse else x_seq
        layer = FusedLSTM.apply if training else fused_lstm
        # both work in f32 internally and return x's dtype
        ys, h_f, c_f = layer(xs, h0, c0, w_i2h.t(), w_h2h.t(),
                             b_i2h + b_h2h)
        if reverse:
            ys = torch.flip(ys, (0,))
        return ys, h_f, c_f

    # the x projection of every step is one matmul, as in the kernel path
    xp = torch.matmul(x_seq, w_i2h.t()) + b_i2h
    h, c = h0, c0
    ys = [None] * x_seq.shape[0]
    steps = range(x_seq.shape[0] - 1, -1, -1) if reverse \
        else range(x_seq.shape[0])
    for t in steps:
        hp = torch.matmul(h, w_h2h.t()) + b_h2h
        if mode == "lstm":
            i, f, g, o = torch.chunk(xp[t] + hp, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            # cuDNN gru: r, z, n with a separate h2h term for n
            xr, xz, xn = torch.chunk(xp[t], 3, dim=-1)
            hr, hz, hn = torch.chunk(hp, 3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
        else:
            act = torch.relu if mode == "rnn_relu" else torch.tanh
            h = act(xp[t] + hp)
        ys[t] = h
    return torch.stack(ys), h, c


def _rnn_draws(params):
    """Whether a call draws its inter-layer dropout masks: in training,
    with ``p > 0`` and more than one layer. Otherwise the op takes no
    generator, so it runs inside a CUDA graph capture."""
    return (float(params.get("p", 0.0)) > 0
            and int(params.get("num_layers", 1)) > 1
            and params.get("_is_train", False))


@register("RNN", num_outputs=_rnn_nout, need_train_flag=True,
          need_rng=_rnn_draws)
def _rnn(params, data, parameters, state, *state_cell):
    """Fused multi-layer (bi)RNN over time-major data (T, B, I); between
    layers, in training, dropout at ``p`` from the op's generator."""
    mode = params["mode"]
    H = params["state_size"]
    num_layers = params.get("num_layers", 1)
    bidir = params.get("bidirectional", False)
    p_drop = float(params.get("p", 0.0))
    d = 2 if bidir else 1
    T, B, I = data.shape
    if state.shape[1] == 1 and B != 1:
        # begin-state zeros are created batch-1 (symbolic shape inference
        # has no unknown-batch placeholder); broadcast to the data batch
        state = state.expand(state.shape[0], B, state.shape[2])
    c_in = state_cell[0] if (mode == "lstm" and state_cell) \
        else torch.zeros_like(state)
    if c_in.shape[1] == 1 and B != 1:
        c_in = c_in.expand(c_in.shape[0], B, c_in.shape[2])
    weights, biases = _unpack_rnn_params(parameters, num_layers, I, H, bidir,
                                         mode)
    x = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs = []
        for dr in range(d):
            li = layer * d + dr
            w_i2h, w_h2h = weights[li]
            b_i2h, b_h2h = biases[li]
            ys, h_f, c_f = _rnn_cell_scan(mode, x, state[li], c_in[li],
                                          w_i2h, w_h2h, b_i2h, b_h2h,
                                          reverse=(dr == 1))
            outs.append(ys)
            h_finals.append(h_f)
            c_finals.append(c_f)
        x = torch.cat(outs, dim=-1) if d == 2 else outs[0]
        if layer < num_layers - 1 and _rnn_draws(params):
            keep = torch.full_like(x, 1 - p_drop)
            mask = torch.bernoulli(keep, generator=params["_generator"])
            x = x * mask / (1 - p_drop)
    outs = (x,)
    if params.get("state_outputs", False):
        outs = outs + (torch.stack(h_finals),)
        if mode == "lstm":
            outs = outs + (torch.stack(c_finals),)
    return outs


# ---------------------------------------------------------------------------
# Convolution (reference nn/convolution-inl.h)
# ---------------------------------------------------------------------------
def _tup(v, n, default):
    if v is None or v == () or v == []:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _channel_last(params, nd):
    """The ``layout`` attribute: False for NC<spatial> (the default,
    weights OI<spatial>), True for N<spatial>C (weights O<spatial>I)."""
    spec = "DHW"[3 - nd:]
    layout = params.get("layout") or ("NC" + spec)
    if layout in ("None", "NC" + spec):
        return False
    if layout == "N" + spec + "C":
        return True
    raise MXNetError("unsupported layout " + str(layout))


def _first_channels(x, nd):
    """A channel-last tensor as a channel-first view (no copy): PyTorch's
    convolutions and pools read it as channels-last memory."""
    return x.permute(0, nd + 1, *range(1, nd + 1))


def _last_channels(x, nd):
    return x.permute(0, *range(2, nd + 2), 1)


def _env_on(name, default="0"):
    """Boolean env gate: '0'/''/'false'/'off'/'no' (any case) disable."""
    return os.environ.get(name, default).lower() not in (
        "0", "", "false", "off", "no")


def _conv(data, weight, stride, pad, dilate, groups, channel_last):
    nd = data.dim() - 2
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    if not channel_last:
        return conv(data, weight, None, stride, pad, dilate, groups)
    out = conv(_first_channels(data, nd), _first_channels(weight, nd), None,
               stride, pad, dilate, groups)
    return _last_channels(out, nd)


def _plain_1x1(kernel, pad, dilate, groups):
    """Pointwise conv: 1x1 kernel, no padding/dilation/groups."""
    return (set(kernel) == {1} and set(pad) == {0} and set(dilate) == {1}
            and groups == 1)


def _conv1x1_pallas_wanted(kernel, stride, pad, dilate, groups,
                           channel_last, nd, dshape):
    """The JAX package's gate and eligibility test (`nn.py:371-383`):
    ``MXNET_CONV1X1_PALLAS`` on, an NHWC stride-2 1x1 conv, even input
    height and width and input channels a multiple of 128."""
    if not _env_on("MXNET_CONV1X1_PALLAS"):
        return False
    if not _plain_1x1(kernel, pad, dilate, groups) or nd != 2 \
            or not channel_last:
        return False
    if stride != (2, 2):
        return False
    return dshape[1] % 2 == 0 and dshape[2] % 2 == 0 and dshape[3] % 128 == 0


class _Conv1x1S2(torch.autograd.Function):
    """NHWC stride-2 1x1 conv whose input gradient is K5 (the JAX
    package's ``_conv1x1_pallas_fn``). Forward is the plain convolution;
    the one residual is the strided input slice ``x[:, ::2, ::2, :]`` (a
    view); ``dx`` is ``conv1x1_s2_dgrad`` (the kernel on a CUDA tensor,
    its plain version on the CPU) and ``dw = dy^T x_strided`` is one
    matrix product outside the kernel, accumulated in f32 (cuBLAS's
    compute type for f32 and bf16 products), as in the JAX package."""

    @staticmethod
    def forward(ctx, data, weight):
        ctx.save_for_backward(data[:, ::2, ::2, :], weight)
        ctx.hw = (data.shape[1], data.shape[2])
        return _conv(data, weight, (2, 2), (0, 0), (1, 1), 1, True)

    @staticmethod
    def backward(ctx, dy):
        xs, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv1x1_s2_dgrad(dy, weight.reshape(weight.shape[0], -1),
                                  *ctx.hw)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(dy.reshape(-1, dy.shape[-1]).t(),
                              xs.reshape(-1, xs.shape[-1]))
            dw = dw.reshape(weight.shape).to(weight.dtype)
        return dx, dw


@register("Convolution", aliases=("Convolution_v1",))
def _convolution(params, data, weight, *bias):
    """Reference convolution-inl.h, channel-first or channel-last. A
    channel-last conv runs on channels-last views of its NHWC tensors, so
    nothing is copied around cuDNN."""
    kernel = tuple(int(k) for k in params["kernel"])
    nd = len(kernel)
    stride = _tup(params.get("stride"), nd, 1)
    dilate = _tup(params.get("dilate"), nd, 1)
    pad = _tup(params.get("pad"), nd, 0)
    groups = int(params.get("num_group", 1))
    channel_last = _channel_last(params, nd)
    if _conv1x1_pallas_wanted(kernel, stride, pad, dilate, groups,
                              channel_last, nd, data.shape):
        out = _Conv1x1S2.apply(data, weight)
    else:
        out = _conv(data, weight, stride, pad, dilate, groups, channel_last)
    if not _attr_bool(params, "no_bias") and bias:
        out = out + (bias[0] if channel_last
                     else bias[0].reshape((1, -1) + (1,) * nd))
    return (out,)


@register("Deconvolution")
def _deconvolution(params, data, weight, *bias):
    """Reference deconvolution-inl.h, channel-first: the transposed
    convolution with weights (in, out/groups, k...), ``adj`` added to the
    output's far end (PyTorch's ``output_padding``), in the data's
    dtype. The JAX op has no channel-last form; a channel-last layout
    raises here."""
    kernel = tuple(int(k) for k in params["kernel"])
    nd = len(kernel)
    if _channel_last(params, nd):
        raise MXNetError("Deconvolution supports only channel-first "
                         "layouts")
    conv = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nd - 1]
    out = conv(data, weight, None, _tup(params.get("stride"), nd, 1),
               _tup(params.get("pad"), nd, 0), _tup(params.get("adj"), nd, 0),
               int(params.get("num_group", 1)),
               _tup(params.get("dilate"), nd, 1)).to(data.dtype)
    if not _attr_bool(params, "no_bias") and bias:
        out = out + bias[0].reshape((1, -1) + (1,) * nd)
    return (out,)


# ---------------------------------------------------------------------------
# BatchNorm (reference nn/batch_norm-inl.h)
# ---------------------------------------------------------------------------
def _bn_shape(data, axis):
    return tuple(-1 if i == axis else 1 for i in range(data.dim()))


def _bn_apply(data, g, beta, mean, inv, bshape):
    """One scale/shift multiply-add in the data dtype, from f32 statistics
    (`nn.py:_bn_apply`); ``addcmul`` rounds once, as a fused XLA
    multiply-add does."""
    scale = g.float() * inv
    shift = beta.float() - mean * scale
    return torch.addcmul(shift.to(data.dtype).reshape(bshape), data,
                         scale.to(data.dtype).reshape(bshape))


class _BatchNormTrain(torch.autograd.Function):
    """Training BatchNorm core with the JAX package's fused backward
    (`_bn_train_core`, `_bn_core_bwd`). Statistics are single-pass
    ``E[x^2] - mean^2`` in f32; the residuals are the input, gamma, the
    mean and ``1/sqrt(var + eps)``, and the backward recomputes ``x_hat``
    from them. ``mean`` and ``var`` (f32) are statistics and carry no
    gradient.

    The full-size passes read a bf16 activation as bf16 and do their
    arithmetic in f32 (reductions with ``dtype=float32`` and mixed-dtype
    elementwise ops promote on load): the forward reads it twice for the
    statistics and once for the scale/shift, and writes no f32 copy; the
    backward writes one f32 ``x - mean`` and forms dx as
    ``a*dy + b*(x - mean) + c`` with per-channel f32 ``a, b, c``, which is
    ``coef * (dy - mean(dy) - x_hat * mean(dy * x_hat))`` regrouped."""

    @staticmethod
    def forward(ctx, data, g, beta, axis, eps):
        red = tuple(i for i in range(data.dim()) if i != axis)
        bshape = _bn_shape(data, axis)
        n = data.numel() // max(data.shape[axis], 1)
        mean = torch.sum(data, red, dtype=torch.float32) / n
        norm = torch.linalg.vector_norm(data, 2, red, dtype=torch.float32)
        var = torch.clamp(norm * norm / n - mean * mean, min=0)
        inv = torch.rsqrt(var + eps)
        out = _bn_apply(data, g, beta, mean, inv, bshape)
        ctx.save_for_backward(data, g, mean, inv)
        ctx.axis = axis
        ctx.beta_dtype = beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        data, g, mean, inv = ctx.saved_tensors
        red = tuple(i for i in range(data.dim()) if i != ctx.axis)
        bshape = _bn_shape(data, ctx.axis)
        n = data.numel() // max(data.shape[ctx.axis], 1)
        # x - mean in f32 (a bf16 x is promoted as it is read), as the
        # JAX package centres x_hat: sum(dy * x_hat) without cancellation
        xc = torch.sub(data, mean.reshape(bshape))
        sum_dy = torch.sum(dy, red, dtype=torch.float32)
        sum_dy_xhat = torch.sum(dy * xc, red) * inv
        a = g.float() * inv
        b = -a * inv * sum_dy_xhat / n
        c = -a * sum_dy / n
        dx = torch.addcmul(torch.addcmul(c.reshape(bshape), xc,
                                         b.reshape(bshape)),
                           dy, a.reshape(bshape))
        return (dx.to(data.dtype), sum_dy_xhat.to(g.dtype),
                sum_dy.to(ctx.beta_dtype), None, None)


@register("BatchNorm", aliases=("BatchNorm_v1", "CuDNNBatchNorm"),
          need_train_flag=True,
          num_outputs=3, mutate_aux=(3, 4), num_visible_outputs=1)
def _batch_norm(params, data, gamma, beta, moving_mean, moving_var):
    """Reference nn/batch_norm-inl.h. Outputs (out, mean, var), then the
    new moving statistics (the aux inputs 3 and 4) in training; mean and
    var are f32 whatever the data dtype, and the moving statistics keep
    their own dtype. ``_fold_bias`` is the bias of a producing conv that
    the executor folded out (`executor._plan_conv_bias_bn_fold`): the
    input is x where the graph normalised x + b, so only the moving-mean
    bookkeeping (and the eval-mode shift) sees b."""
    eps = float(params.get("eps", 1e-3))
    momentum = float(params.get("momentum", 0.9))
    axis = int(params.get("axis", 1)) % data.dim()
    fix_gamma = _attr_bool(params, "fix_gamma", True)
    use_global = _attr_bool(params, "use_global_stats") \
        or not params.get("_is_train", False)
    fold_b = params.get("_fold_bias")
    g = torch.ones_like(gamma) if fix_gamma else gamma
    bshape = _bn_shape(data, axis)
    if use_global:
        m32 = moving_mean.float()
        if fold_b is not None:
            m32 = m32 - fold_b.float()
        inv = torch.rsqrt(moving_var.float() + eps)
        out = _bn_apply(data, g, beta, m32, inv, bshape)
        return (out, moving_mean.float(), moving_var.float(), moving_mean,
                moving_var)
    out, mean, var = _BatchNormTrain.apply(data, g, beta, axis, eps)
    with torch.no_grad():
        if fold_b is not None:
            mean = mean + fold_b.float()
        new_mm = momentum * moving_mean \
            + (1 - momentum) * mean.to(moving_mean.dtype)
        new_mv = momentum * moving_var \
            + (1 - momentum) * var.to(moving_var.dtype)
    return (out, mean, var, new_mm, new_mv)


# ---------------------------------------------------------------------------
# Pooling (reference nn/pooling-inl.h)
# ---------------------------------------------------------------------------
def _pad_spatial(x, lo, hi, value):
    """Pad the trailing spatial axes of a channel-first tensor."""
    widths = []
    for a, b in zip(reversed(lo), reversed(hi)):
        widths += [a, b]
    return F.pad(x, widths, value=value)


@register("Pooling", aliases=("Pooling_v1",))
def _pooling(params, data):
    """Max, avg and sum pooling, global or windowed, with symmetric or
    ``pad_end`` padding and the ``valid``/``full`` conventions of the JAX
    package: padding never joins a max, and an average divides by the
    window size unless ``count_include_pad`` is false. ``_fold_relu`` is
    the executor's relu->maxpool fold: ``max(maxpool(x), 0)``."""
    pool_type = params.get("pool_type", "max")
    nd = data.dim() - 2
    channel_last = _channel_last(params, nd)
    spatial_axes = tuple(range(1, 1 + nd)) if channel_last \
        else tuple(range(2, 2 + nd))
    if _attr_bool(params, "global_pool"):
        if pool_type == "max":
            out = data.amax(dim=spatial_axes, keepdim=True)
        elif pool_type in ("avg", "sum"):
            out = data.mean(dim=spatial_axes, keepdim=True) \
                if pool_type == "avg" else data.sum(spatial_axes, keepdim=True)
        else:
            raise MXNetError("unsupported pool_type " + pool_type)
        if pool_type == "max" and params.get("_fold_relu"):
            out = torch.clamp_min(out, 0)
        return (out,)
    x = _first_channels(data, nd) if channel_last else data
    spatial = tuple(x.shape[2:])
    kernel = _tup(params["kernel"], nd, 1)
    stride = _tup(params.get("stride"), nd, 1)
    lo = _tup(params.get("pad"), nd, 0)
    hi = _tup(params["pad_end"], nd, 0) if params.get("pad_end") is not None \
        else lo
    for k, size, p, pe in zip(kernel, spatial, lo, hi):
        if k > size + p + pe:
            raise MXNetError("Pooling kernel %s exceeds padded input %s"
                             % (kernel, spatial))
    if params.get("pooling_convention", "valid") == "full":
        # ceil-mode output: extend the end padding as needed
        hi = tuple(max((math.ceil((size + p + pe - k) / s)) * s + k - size - p,
                       pe)
                   for k, s, size, p, pe in zip(kernel, stride, spatial, lo,
                                                hi))
    # PyTorch pads implicitly only symmetrically and by at most half a
    # window; anything else is padded explicitly
    native = tuple(lo) == tuple(hi) and all(p <= k // 2
                                            for p, k in zip(lo, kernel))
    if pool_type == "max":
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        if native:
            out = pool(x, kernel, stride, lo)
        else:
            out = pool(_pad_spatial(x, lo, hi, float("-inf")), kernel, stride)
        if params.get("_fold_relu"):
            out = torch.clamp_min(out, 0)
    elif pool_type in ("avg", "sum"):
        pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nd - 1]
        include_pad = _attr_bool(params, "count_include_pad", True)
        # torch's CPU avg_pool3d has no bf16/f16 kernel: pool in f32 there
        # and round the result once to the data dtype
        upcast = (nd == 3 and x.device.type == "cpu"
                  and x.dtype in (torch.bfloat16, torch.float16))
        xin = x.float() if upcast else x
        if native and pool_type == "avg" and include_pad:
            out = pool(xin, kernel, stride, lo, count_include_pad=True)
        else:
            size = math.prod(kernel)
            out = pool(_pad_spatial(xin, lo, hi, 0.0), kernel, stride)
            if pool_type == "sum":
                out = out * size
            elif not include_pad:
                ones = _pad_spatial(torch.ones_like(xin), lo, hi, 0.0)
                out = out * size / (pool(ones, kernel, stride) * size)
        if upcast:
            out = out.to(x.dtype)
    else:
        raise MXNetError("unsupported pool_type " + pool_type)
    return (_last_channels(out, nd) if channel_last else out,)


# ---------------------------------------------------------------------------
# Resizing: adaptive pooling, bilinear resize, UpSampling
# ---------------------------------------------------------------------------
def _linear_resize_weights(n_in, n_out, device):
    """The (n_in, n_out) weights of ``jax.image.resize(method="linear")``
    along one axis: half-pixel centres, a triangle kernel widened by the
    shrink factor when shrinking (antialiasing), each output's weights
    normalised to sum 1 (`jax/_src/image/scale.py::compute_weight_mat`),
    computed in f64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float64,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_linear(data, size):
    """``jax.image.resize(data, (N, C) + size, method="linear")`` on an
    NCHW tensor: one weight product per resized axis, in the data's
    dtype (f32 for an integer input)."""
    x = data if data.is_floating_point() else data.float()
    for axis, n_out in zip((2, 3), size):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = _linear_resize_weights(n_in, n_out, x.device).to(x.dtype)
        x = torch.movedim(torch.matmul(torch.movedim(x, axis, -1), w),
                          -1, axis)
    return x


@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool(params, data):
    """The mean over equal windows when ``output_size`` divides the input
    size; otherwise the JAX package's fallback, a linear resize (not the
    reference's uneven windows)."""
    oh, ow = _tup(params.get("output_size", 1), 2, 1)
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return (data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5)),)
    return (_resize_linear(data, (oh, ow)),)


@register("_contrib_BilinearResize2D")
def _bilinear_resize(params, data):
    h, w = int(params["height"]), int(params["width"])
    return (_resize_linear(data, (h, w)).to(data.dtype),)


@register("UpSampling")
def _upsampling(params, *inputs):
    """Enlarge the first input's two trailing axes by ``scale``: by
    repetition (``nearest``) or a linear resize (``bilinear``; the
    reference's deconvolution weight input is not read, as in the JAX
    package)."""
    scale = int(params["scale"])
    data = inputs[0]
    if params.get("sample_type", "nearest") == "nearest":
        out = data.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                    dim=3)
    else:
        out = _resize_linear(data, (data.shape[2] * scale,
                                    data.shape[3] * scale))
    return (out.to(data.dtype),)


# ---------------------------------------------------------------------------
# Activation (reference nn/activation-inl.h)
# ---------------------------------------------------------------------------
_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


@register("Activation")
def _activation(params, data):
    act = params["act_type"]
    if act not in _ACTIVATIONS:
        raise MXNetError("unknown act_type " + act)
    return (_ACTIVATIONS[act](data),)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _rrelu_draws(params):
    return params.get("act_type", "leaky") == "rrelu" \
        and params.get("_is_train", False)


@register("LeakyReLU", need_rng=_rrelu_draws, need_train_flag=True)
def _leaky_relu(params, data, *gamma):
    """Reference nn/leaky_relu-inl.h: the negative side scaled by
    ``slope`` (``leaky``), ``slope * expm1`` (``elu``), SELU's constants
    (``selu``), the per-channel ``gamma`` input (``prelu``), or slopes
    drawn uniformly from [``lower_bound``, ``upper_bound``) in training
    and their mean otherwise (``rrelu``)."""
    act = params.get("act_type", "leaky")
    slope = float(params.get("slope", 0.25))
    pos = data >= 0
    if act == "leaky":
        return (torch.where(pos, data, slope * data),)
    if act == "elu":
        return (torch.where(pos, data, slope * torch.expm1(data)),)
    if act == "selu":
        return (_SELU_SCALE * torch.where(
            pos, data, _SELU_ALPHA * torch.expm1(data)),)
    if act == "prelu":
        g = gamma[0].reshape((1, -1) + (1,) * (data.dim() - 2))
        return (torch.where(pos, data, g * data),)
    if act == "rrelu":
        lo = float(params.get("lower_bound", 0.125))
        hi = float(params.get("upper_bound", 0.334))
        if _rrelu_draws(params):
            u = torch.rand(data.shape, generator=params["_generator"],
                           device=data.device)
            slopes = (lo + (hi - lo) * u).to(data.dtype)
        else:
            slopes = (lo + hi) / 2.0
        return (torch.where(pos, data, slopes * data),)
    raise MXNetError("unknown act_type " + act)


@register("SoftmaxActivation")
def _softmax_activation(params, data):
    """Softmax over axis 1 (``mode="channel"``) or over each instance's
    values (``instance``, the default)."""
    if params.get("mode", "instance") == "channel":
        return (torch.softmax(data, dim=1),)
    return (torch.softmax(data.reshape(data.shape[0], -1), dim=-1)
            .reshape(data.shape),)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(params, data, label):
    """The summed cross entropy of the rows of ``data`` against integer
    ``label``s (a label outside the classes adds nothing), a 0-d
    array."""
    logp = torch.log_softmax(data, dim=-1)
    hot = label.long().unsqueeze(-1) == torch.arange(data.shape[-1],
                                                     device=data.device)
    return (-torch.sum(hot.to(data.dtype) * logp),)


def _dropout_draws(params):
    return float(params.get("p", 0.5)) > 0 and (
        params.get("_is_train", False)
        or params.get("mode", "training") == "always")


@register("Dropout", need_rng=_dropout_draws, need_train_flag=True,
          num_outputs=2, num_visible_outputs=1)
def _dropout(params, data):
    """Reference nn/dropout-inl.h: outputs (out, mask), the mask 0 or
    1/(1-p) from a Bernoulli draw of the op's generator, in training or
    under ``mode="always"``; otherwise the identity and a mask of ones.
    ``axes`` is ignored, as in the JAX package."""
    if not _dropout_draws(params):
        return (data, torch.ones_like(data))
    keep = 1.0 - float(params.get("p", 0.5))
    bits = torch.bernoulli(torch.full(data.shape, keep, device=data.device),
                           generator=params["_generator"])
    mask = bits.to(data.dtype) / keep
    return (data * mask, mask)


# ---------------------------------------------------------------------------
# LayerNorm (reference nn/layer_norm-inl.h)
# ---------------------------------------------------------------------------
@register("LayerNorm", num_outputs=3, num_visible_outputs=1)
def _layer_norm(params, data, gamma, beta):
    """Normalise over ``axis`` (default the last): statistics in f32, the
    normalised value cast to the data dtype before gamma and beta, as the
    JAX package does for bf16 stability. Outputs (out, mean, std), the
    last two hidden and in f32; the gradient is autograd's over these
    ops."""
    axis = int(params.get("axis", -1))
    eps = float(params.get("eps", 1e-5))
    x32 = data.float()
    mean = x32.mean(axis, keepdim=True)
    var = x32.var(axis, unbiased=False, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = out * gamma.reshape(shape) + beta.reshape(shape)
    return (out, mean.squeeze(axis), torch.sqrt(var + eps).squeeze(axis))


@register("InstanceNorm")
def _instance_norm(params, data, gamma, beta):
    """Normalise each sample's channel over its spatial axes (statistics
    in the data's dtype, as in the JAX op), then scale by ``gamma`` and
    shift by ``beta`` per channel."""
    eps = float(params.get("eps", 1e-3))
    axes = tuple(range(2, data.dim()))
    mean = data.mean(axes, keepdim=True)
    var = data.var(axes, unbiased=False, keepdim=True)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    out = (data - mean) * torch.rsqrt(var + eps)
    return (out * gamma.reshape(shape) + beta.reshape(shape),)


@register("LRN")
def _lrn(params, data):
    """Reference lrn-inl.h: each value over
    ``(knorm + alpha / nsize * sum of squares over nsize channels)**beta``,
    the window centred on the channel and cut at the ends."""
    nsize = int(params["nsize"])
    alpha = float(params.get("alpha", 1e-4))
    beta = float(params.get("beta", 0.75))
    knorm = float(params.get("knorm", 2.0))
    n, c = data.shape[:2]
    sq = torch.square(data).reshape(n, 1, c, -1)
    half = nsize // 2
    ssum = F.avg_pool2d(sq, (nsize, 1), 1, (half, 0),
                        count_include_pad=True) * nsize
    return (data / torch.pow(knorm + alpha / nsize * ssum.reshape(data.shape),
                             beta),)
