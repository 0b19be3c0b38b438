"""Neural-network operators (the subset the LSTM LM slices use).

Counterpart of `mxnet_tpu/ops/nn.py`: ``FullyConnected``, ``softmax``,
the ``SoftmaxOutput`` loss head and the fused multi-layer ``RNN`` op with
its cuDNN flat parameter layout. An LSTM layer that needs a gradient runs
``FusedLSTM`` (the hand-written training kernels K2/K3 on a CUDA tensor,
their plain versions on the CPU); otherwise it runs the inference kernel
``fused_lstm`` (K1) on a CUDA tensor and a plain loop over time
everywhere else (CPU, and ``meta`` tensors during shape inference).
"""
from __future__ import annotations

import torch

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


def _softmax_output_grad(out, label, params):
    """(p - onehot(label)), masked and scaled as the attributes say
    (`mxnet_tpu/ops/nn.py::_so_grad` and ``_normalize_grad``). Labels
    outside [0, C) give a zero one-hot row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(out.shape[-1], device=out.device)
    onehot = (label.long()[..., None] == classes).to(out.dtype)
    grad = out - onehot
    ignore = _attr_num(params, "ignore_label", -1)
    if _attr_bool(params, "use_ignore"):
        grad = grad * (label != ignore).to(out.dtype)[..., None]
    scale = _attr_num(params, "grad_scale", 1.0)
    norm = params.get("normalization", "null")
    if norm == "batch":
        scale = scale / label.shape[0]
    elif norm == "valid":
        valid = torch.clamp((label != ignore).sum(), min=1).to(out.dtype)
        return grad * (scale / valid)
    return grad * scale


class _SoftmaxOutputHead(torch.autograd.Function):
    """Softmax over the last axis forward; backward (p - y) whatever the
    incoming gradient, as the reference's loss heads."""

    @staticmethod
    def forward(ctx, data, label, params):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.params = params
        return out

    @staticmethod
    def backward(ctx, _):
        out, label = ctx.saved_tensors
        return _softmax_output_grad(out, label, ctx.params), None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(params, data, label):
    """Reference softmax_output-inl.h: forward softmax, backward (p - y)."""
    attrs = {k: v for k, v in params.items() if not k.startswith("_")}
    head = _SoftmaxOutputHead.apply
    if _attr_bool(params, "multi_output"):
        # data (N, C, d...) label (N, d...): softmax over axis 1
        perm = (0,) + tuple(range(2, data.dim())) + (1,)
        inv = (0, data.dim() - 1) + tuple(range(1, data.dim() - 1))
        return (head(data.permute(*perm), label, attrs).permute(*inv),)
    if data.dim() > 2:
        out = head(data.reshape(-1, data.shape[-1]), label.reshape(-1), attrs)
        return (out.reshape(data.shape),)
    return (head(data, label, attrs),)


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


@register("RNN", num_outputs=_rnn_nout, need_train_flag=True, need_rng=True)
def _rnn(params, data, parameters, state, *state_cell):
    """Fused multi-layer (bi)RNN over time-major data (T, B, I)."""
    mode = params["mode"]
    H = params["state_size"]
    num_layers = params.get("num_layers", 1)
    bidir = params.get("bidirectional", False)
    p_drop = params.get("p", 0.0)
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
        if p_drop > 0 and params.get("_is_train", False) \
                and layer < num_layers - 1:
            keep = torch.full_like(x, 1 - p_drop)
            mask = torch.bernoulli(keep, generator=params["_generator"])
            x = x * mask / (1 - p_drop)
    outs = (x,)
    if params.get("state_outputs", False):
        outs = outs + (torch.stack(h_finals),)
        if mode == "lstm":
            outs = outs + (torch.stack(c_finals),)
    return outs
