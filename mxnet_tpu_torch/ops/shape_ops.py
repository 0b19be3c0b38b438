"""Shape and indexing operators (the subset the port's slices use).

Counterpart of `mxnet_tpu/ops/shape_ops.py`: ``Reshape`` with the
reference's shape-spec codes, ``reshape_like``, ``Flatten``,
``transpose``, ``SwapAxis``, ``Embedding`` and ``pick``.
"""
from __future__ import annotations

import torch

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
