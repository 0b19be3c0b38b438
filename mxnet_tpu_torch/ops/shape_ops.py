"""Shape, layout, indexing and ordering operators.

Counterpart of `mxnet_tpu/ops/shape_ops.py` (reference
`src/operator/tensor/matrix_op-inl.h`, `indexing_op.h`,
`ordering_op-inl.h` and the `sequence_*` ops), with the same names and
aliases: ``Reshape`` with the reference's shape-spec codes,
``reshape_like``, ``Flatten``, ``transpose``, ``SwapAxis``,
``expand_dims``, ``squeeze``, the ``broadcast_to``/``_like``/``_axis``
family, ``tile``, ``repeat``, ``Pad``, ``slice``/``crop``,
``slice_axis``, ``slice_like``, ``SliceChannel``/``split``, ``Concat``,
``stack``, ``flip``, ``depth_to_space``/``space_to_depth``, ``diag``,
``shape_array``/``size_array``; ``dot``, ``batch_dot`` and
``khatri_rao`` (plain products, which the JAX package leaves to XLA and
the port to ``torch.matmul``); ``Embedding``, ``take``, ``batch_take``,
``pick``, ``one_hot``, ``gather_nd``, ``scatter_nd`` and
``_scatter_set_nd``; ``sort``, ``argsort``, ``topk``, ``argmax``,
``argmin`` and ``argmax_channel`` (indices as f32 unless ``dtype`` says
otherwise, as in the reference); ``SequenceMask``, ``SequenceLast`` and
``SequenceReverse`` over (seq, batch, ...) data. A broadcast result is a
copy, not an expanded view, since the port's arrays can be written in
place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register


def infer_reshape(src_shape, spec, reverse=False):
    """The reference reshape shape-spec language
    (matrix_op-inl.h:95-180): 0 copy-dim, -1 infer, -2 copy-rest,
    -3 merge-two, -4 split-two."""
    if reverse:
        out = infer_reshape(list(src_shape)[::-1], list(spec)[::-1])
        return tuple(out[::-1])
    src = list(src_shape)
    out = []
    si = 0
    i = 0
    spec = list(spec)
    while i < len(spec):
        s = spec[i]
        if s == 0:
            out.append(src[si])
            si += 1
        elif s == -1:
            out.append(-1)
            si += 1
        elif s == -2:
            out.extend(src[si:])
            si = len(src)
        elif s == -3:
            out.append(src[si] * src[si + 1])
            si += 2
        elif s == -4:
            d1, d2 = spec[i + 1], spec[i + 2]
            if d1 == -1:
                d1 = src[si] // d2
            if d2 == -1:
                d2 = src[si] // d1
            out.extend([d1, d2])
            si += 1
            i += 2
        else:
            out.append(int(s))
            si += 1
        i += 1
    if -1 in out:
        known = 1
        for v in out:
            if v != -1:
                known *= v
        total = 1
        for v in src_shape:
            total *= v
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def _reshape(params, x):
    tgt = infer_reshape(x.shape, params.get("shape", ()),
                        params.get("reverse", False))
    return (x.reshape(tgt),)


@register("reshape_like")
def _reshape_like(params, x, other):
    """``x`` in ``other``'s shape (``other``'s values are not read, so it
    takes no gradient)."""
    return (x.reshape(other.shape),)


@register("Flatten", aliases=("flatten",))
def _flatten(params, x):
    return (x.reshape(x.shape[0], -1),)


@register("transpose")
def _transpose(params, x):
    axes = params.get("axes") or tuple(reversed(range(x.dim())))
    return (x.permute(*axes),)


@register("SwapAxis", aliases=("swapaxes",))
def _swapaxes(params, x):
    return (x.transpose(params["dim1"], params["dim2"]),)


@register("Embedding")
def _embedding(params, data, weight):
    """Reference indexing_op.h Embedding: a row gather; out-of-range ids
    are clipped as in the JAX package."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    rows = weight.index_select(0, idx.reshape(-1))
    return (rows.reshape(tuple(idx.shape) + (weight.shape[1],)),)


@register("pick")
def _pick(params, x, index):
    """``x``'s element at ``index`` along ``axis`` (the axis dropped
    unless ``keepdims``). An index outside the axis is clipped to it
    (``mode="clip"``, the reference's default) or taken modulo its
    length (``mode="wrap"``)."""
    axis = int(params.get("axis", -1)) % x.dim()
    n = x.shape[axis]
    idx = index.long()
    idx = idx.remainder(n) if params.get("mode", "clip") == "wrap" \
        else idx.clamp(0, n - 1)
    out = torch.gather(x, axis, idx.unsqueeze(axis))
    if not params.get("keepdims", False):
        out = out.squeeze(axis)
    return (out,)


@register("expand_dims")
def _expand_dims(params, x):
    return (x.unsqueeze(int(params["axis"])),)


@register("squeeze")
def _squeeze(params, x):
    axis = params.get("axis")
    if axis is None:
        return (x.squeeze(),)
    return (x.squeeze(axis if isinstance(axis, int) else tuple(axis)),)


def _broadcast(x, shape):
    return x.expand(tuple(shape)).contiguous()


@register("broadcast_to")
def _broadcast_to(params, x):
    """A 0 in ``shape`` keeps that axis's size."""
    return (_broadcast(x, [t if t != 0 else s
                           for t, s in zip(params["shape"], x.shape)]),)


@register("broadcast_like")
def _broadcast_like(params, x, other):
    return (_broadcast(x, other.shape),)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(params, x):
    axes, sizes = params["axis"], params["size"]
    if not isinstance(axes, (tuple, list)):
        axes, sizes = (axes,), (sizes,)
    tgt = list(x.shape)
    for a, n in zip(axes, sizes):
        tgt[a] = n
    return (_broadcast(x, tgt),)


@register("tile")
def _tile(params, x):
    reps = params["reps"]
    return (torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps)),)


@register("repeat")
def _repeat(params, x):
    """``np.repeat``: with no axis, over the flattened array."""
    return (torch.repeat_interleave(x, int(params["repeats"]),
                                    dim=params.get("axis")),)


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@register("Pad", aliases=("pad",))
def _pad(params, x):
    """``pad_width`` holds (before, after) for every axis, numpy's order;
    ``edge`` and ``reflect`` pad the trailing axes from the first padded
    one, as the reference allows."""
    pw = list(params["pad_width"])
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    mode = params.get("mode", "constant")
    if mode != "constant":
        first = next((i for i, p in enumerate(pairs) if any(p)),
                     len(pairs))
        pairs = pairs[first:]
    flat = [v for p in reversed(pairs) for v in p]
    if mode == "constant":
        return (F.pad(x, flat, value=float(params.get("constant_value",
                                                      0))),)
    return (F.pad(x, flat, mode=_PAD_MODES[mode]),)


def _take_range(x, axis, sl):
    """``x`` along ``axis`` by a Python slice, negative steps included."""
    if sl.step is None or sl.step > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = sl
        return x[tuple(idx)]
    rows = range(*sl.indices(x.shape[axis]))
    # the indices made on the device: a CUDA graph can hold that, not a
    # copy from the host
    return x.index_select(axis, torch.arange(
        rows.start, rows.stop, rows.step, dtype=torch.long,
        device=x.device))


@register("slice", aliases=("crop",))
def _slice(params, x):
    begin, end = params["begin"], params["end"]
    step = params.get("step") or [None] * len(begin)
    for a, (b, e, st) in enumerate(zip(begin, end, step)):
        x = _take_range(x, a, slice(b, e, st))
    return (x,)


@register("slice_axis")
def _slice_axis(params, x):
    axis, b, e = int(params["axis"]), params["begin"], params["end"]
    if e is None or e == 0:
        e = x.shape[axis]
    return (_take_range(x, axis, slice(b, e)),)


@register("slice_like")
def _slice_like(params, x, like):
    idx = [slice(None)] * x.dim()
    for a in params.get("axes") or range(x.dim()):
        idx[a] = slice(0, like.shape[a])
    return (x[tuple(idx)],)


@register("SliceChannel", aliases=("split",),
          num_outputs=lambda params: int(params["num_outputs"]))
def _split(params, x):
    """``num_outputs`` equal parts along ``axis`` (default 1), each with
    that axis dropped under ``squeeze_axis``."""
    n = int(params["num_outputs"])
    axis = int(params.get("axis", 1))
    outs = torch.split(x, x.shape[axis] // n, dim=axis)
    if params.get("squeeze_axis"):
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs)


@register("Concat", aliases=("concat",))
def _concat(params, *xs):
    return (torch.cat(xs, dim=int(params.get("dim", 1))),)


@register("stack")
def _stack(params, *xs):
    return (torch.stack(xs, dim=int(params.get("axis", 0))),)


@register("flip", aliases=("reverse",))
def _flip(params, x):
    axis = params["axis"]
    return (torch.flip(x, (axis,) if isinstance(axis, int)
                       else tuple(axis)),)


@register("depth_to_space")
def _depth_to_space(params, x):
    b = int(params["block_size"])
    n, c, h, w = x.shape
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return (y.reshape(n, c // (b * b), h * b, w * b),)


@register("space_to_depth")
def _space_to_depth(params, x):
    b = int(params["block_size"])
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return (y.reshape(n, c * b * b, h // b, w // b),)


@register("diag")
def _diag(params, x):
    """A 1-D input becomes the ``k``-th diagonal of a matrix; otherwise
    the ``k``-th diagonal of axes ``axis1``, ``axis2`` (last)."""
    k = int(params.get("k", 0))
    if x.dim() == 1:
        return (torch.diag(x, k),)
    return (torch.diagonal(x, offset=k, dim1=int(params.get("axis1", 0)),
                           dim2=int(params.get("axis2", 1))),)


def _host_ints(values, device):
    """An int64 vector of host ints, filled on ``device`` (a CUDA graph
    can hold fills, not a copy from the host)."""
    return torch.stack([torch.full((), int(v), dtype=torch.int64,
                                   device=device) for v in values]) \
        if values else torch.zeros(0, dtype=torch.int64, device=device)


@register("shape_array")
def _shape_array(params, x):
    return (_host_ints(x.shape, x.device),)


@register("size_array")
def _size_array(params, x):
    return (_host_ints([x.numel()], x.device),)


def _reversed_axes(x):
    return x.permute(*reversed(range(x.dim())))


@register("dot")
def _dot(params, lhs, rhs):
    """The last axis of ``lhs`` against the first of ``rhs``
    (``transpose_a``/``_b`` reverse an operand's axes first)."""
    a = _reversed_axes(lhs) if params.get("transpose_a") else lhs
    b = _reversed_axes(rhs) if params.get("transpose_b") else rhs
    if a.dim() == 1 and b.dim() == 1:
        return (torch.dot(a, b),)
    if a.dim() <= 2 and b.dim() <= 2:
        return (torch.matmul(a, b),)
    return (torch.tensordot(a, b, dims=([a.dim() - 1], [0])),)


@register("batch_dot")
def _batch_dot(params, lhs, rhs):
    a = lhs.transpose(-1, -2) if params.get("transpose_a") else lhs
    b = rhs.transpose(-1, -2) if params.get("transpose_b") else rhs
    return (torch.matmul(a, b),)


@register("khatri_rao")
def _khatri_rao(params, *xs):
    """The column-wise Kronecker product of the inputs."""
    out = xs[0]
    for x in xs[1:]:
        out = torch.einsum("i...,j...->ij...", out, x).reshape(
            out.shape[0] * x.shape[0], *out.shape[1:])
    return (out,)


def _clip_or_wrap(idx, n, mode):
    idx = idx.long()
    return idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)


@register("take")
def _take(params, a, indices):
    """Rows of ``a`` along ``axis`` (out of range clipped, or wrapped
    under ``mode="wrap"``), in ``indices``' shape."""
    axis = int(params.get("axis", 0)) % a.dim()
    idx = _clip_or_wrap(indices, a.shape[axis], params.get("mode", "clip"))
    out = a.index_select(axis, idx.reshape(-1))
    return (out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                        + tuple(a.shape[axis + 1:])),)


@register("batch_take")
def _batch_take(params, a, indices):
    """``a[i, indices[i]]`` for every row i."""
    return (torch.gather(a, 1, indices.long().reshape(-1, 1)).squeeze(1),)


@register("one_hot")
def _one_hot(params, indices):
    """``on_value`` at each index along a new last axis of ``depth``,
    ``off_value`` elsewhere (an index outside the depth gives a row of
    ``off_value``)."""
    depth = int(params["depth"])
    on = float(params.get("on_value", 1.0))
    off = float(params.get("off_value", 0.0))
    dt = torch_dtype(params.get("dtype", "float32"))
    hot = indices.long().unsqueeze(-1) == torch.arange(
        depth, device=indices.device)
    return ((hot.to(dt) * (on - off) + off).to(dt),)


@register("gather_nd")
def _gather_nd(params, data, indices):
    """``data[indices[0], indices[1], ...]``."""
    return (data[tuple(indices.long())],)


@register("scatter_nd")
def _scatter_nd(params, data, indices):
    """Zeros of ``shape`` with ``data`` written at ``indices``."""
    out = torch.zeros(tuple(params["shape"]), dtype=data.dtype,
                      device=data.device)
    return (out.index_put(tuple(indices.long()), data),)


@register("_scatter_set_nd")
def _scatter_set_nd(params, lhs, rhs, indices):
    return (lhs.index_put(tuple(indices.long()), rhs),)


@register("sort")
def _sort(params, x):
    return (torch.sort(x, dim=int(params.get("axis", -1)),
                       descending=not params.get("is_ascend", True))[0],)


@register("argsort")
def _argsort(params, x):
    """A stable ascending sort's indices, reversed for descending order
    (the JAX package's tie order)."""
    axis = int(params.get("axis", -1))
    out = torch.argsort(x, dim=axis, stable=True)
    if not params.get("is_ascend", True):
        out = torch.flip(out, (axis,))
    return (out.to(torch_dtype(params.get("dtype", "float32"))),)


def _topk_nout(params):
    return 2 if params.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_nout)
def _topk(params, x):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``:
    their indices (``ret_typ="indices"``, as ``dtype``), values, both, or
    a 0/1 mask over ``x``."""
    axis = int(params.get("axis", -1)) % x.dim()
    vals, idxs = torch.topk(x, int(params.get("k", 1)), dim=axis,
                            largest=not params.get("is_ascend", False))
    ret = params.get("ret_typ", "indices")
    if ret == "mask":
        return (torch.zeros_like(x).scatter(axis, idxs, 1),)
    if ret == "value":
        return (vals,)
    idxs = idxs.to(torch_dtype(params.get("dtype", "float32")))
    return (vals, idxs) if ret == "both" else (idxs,)


def _arg_reduce(fn):
    def _op(params, x):
        axis = params.get("axis")
        if axis is None:
            return (fn(x.reshape(-1)).to(torch.float32),)
        return (fn(x, int(axis), bool(params.get("keepdims", False)))
                .to(torch.float32),)
    return _op


register("argmax")(_arg_reduce(torch.argmax))
register("argmin")(_arg_reduce(torch.argmin))


@register("argmax_channel")
def _argmax_channel(params, x):
    return (torch.argmax(x, 1).to(torch.float32),)


def _steps_mask(data, sl, axis):
    """True where the step index along ``axis`` (0 or 1) is below the
    row's length, shaped to broadcast over ``data``."""
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sl[None, :] if axis == 0 \
        else steps[None, :] < sl[:, None]
    return mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))


@register("SequenceMask")
def _sequence_mask(params, data, *seqlen):
    """``value`` at the steps past each row's length (with
    ``use_sequence_length``); ``axis`` 0 is (seq, batch, ...), 1 (batch,
    seq, ...)."""
    if not params.get("use_sequence_length", bool(seqlen)):
        return (data,)
    mask = _steps_mask(data, seqlen[0], int(params.get("axis", 0)))
    value = float(params.get("value", 0.0))
    return (torch.where(mask, data, value).to(data.dtype),)


@register("SequenceLast")
def _sequence_last(params, data, *seqlen):
    """Each row's last step (its length's, with
    ``use_sequence_length``)."""
    axis = int(params.get("axis", 0))
    if not params.get("use_sequence_length", bool(seqlen)):
        return (data.select(axis, -1),)
    dm = data.movedim(axis, 0)
    idx = (seqlen[0].long() - 1).reshape((1, -1) + (1,) * (dm.dim() - 2))
    return (torch.gather(dm, 0, idx.expand((1,) + tuple(dm.shape[1:])))[0],)


@register("SequenceReverse")
def _sequence_reverse(params, data, *seqlen):
    """Each row's first ``length`` steps reversed, the rest in place."""
    axis = int(params.get("axis", 0))
    if not params.get("use_sequence_length", bool(seqlen)):
        return (torch.flip(data, (axis,)),)
    sl = seqlen[0].long()
    dm = data.movedim(axis, 0)
    steps = torch.arange(dm.shape[0], device=data.device)[:, None]
    rev = torch.where(steps < sl[None, :], sl[None, :] - 1 - steps, steps)
    rev = rev.reshape(tuple(rev.shape) + (1,) * (dm.dim() - 2))
    out = torch.gather(dm, 0, rev.expand(tuple(dm.shape)))
    return (out.movedim(0, axis),)
