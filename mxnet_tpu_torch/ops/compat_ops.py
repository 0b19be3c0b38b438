"""The sparse-storage ops of `mxnet_tpu/ops/compat_ops.py`.

Counterparts of the JAX file's sparse block (reference
`tensor/cast_storage-inl.h`, `sparse_retain.cc`, `square_sum`,
`optimizer_op.cc` ``_sparse_adagrad_update``, `indexing_op.cc`
``_contrib_SparseEmbedding``) and ``_identity_with_attr_like_rhs``. As in
the JAX package they compute on the dense layout: the storage type is the
array's, and the math is the same. The rest of the JAX file (legacy
aliases, image ops, samplers, slice assignment) waits for ROADMAP A.7.
"""
from __future__ import annotations

import torch

from .registry import get_op, register


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(params, lhs, rhs):
    """Identity on lhs with rhs's storage attributes (sparse plumbing)."""
    return (lhs,)


@register("cast_storage")
def _cast_storage(params, x):
    """The values do not change with the storage type."""
    return (x,)


@register("_sparse_retain", aliases=("sparse_retain",))
def _sparse_retain(params, data, indices):
    """Keep only the requested rows, zero the rest (ids truncated to
    integers, as the JAX op's ``astype(int32)`` does)."""
    mask = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    mask[indices.long()] = True
    keep = mask.reshape((-1,) + (1,) * (data.dim() - 1))
    return (torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                                device=data.device)),)


@register("_square_sum")
def _square_sum(params, x):
    axis = params.get("axis")
    keepdims = bool(params.get("keepdims", False))
    sq = torch.square(x)
    if axis is None:
        out = sq.sum()
        return (out.reshape((1,) * x.dim()) if keepdims else out,)
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return (sq.sum(dim=dims, keepdim=keepdims),)


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(params, lhs, rhs):
    """lhs / rhs where lhs is non-zero; lhs elsewhere (the reference
    touches only lhs's stored values)."""
    return (torch.where(lhs != 0, lhs / rhs, lhs),)


@register("_scatter_minus_scalar")
def _scatter_minus_scalar(params, x):
    s = params.get("scalar", 0.0)
    return (torch.where(x != 0, x - s, x),)


@register("_sparse_adagrad_update", aliases=("sparse_adagrad_update",),
          mutate_aux=(2,))
def _sparse_adagrad_update(params, weight, grad, history):
    """AdaGrad over a row-sparse gradient on the dense layout (reference
    optimizer_op.cc ``_sparse_adagrad_update``): a row whose gradient is
    all zero keeps its weight and history."""
    lr = params["lr"]
    eps = params.get("epsilon", 1e-7)
    rescale = params.get("rescale_grad", 1.0)
    clip = params.get("clip_gradient", -1.0)
    wd = params.get("wd", 0.0)
    g = grad * rescale
    if clip is not None and clip > 0:
        g = torch.clamp(g, -clip, clip)
    live = (grad != 0).any(dim=tuple(range(1, grad.dim())), keepdim=True) \
        if grad.dim() > 1 else grad != 0
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    new_hist = history + torch.where(live, torch.square(g), zero)
    upd = lr * (g / (torch.sqrt(new_hist) + eps) + wd * weight)
    new_w = weight - torch.where(live, upd, zero)
    return (new_w, new_hist)


@register("_contrib_SparseEmbedding", aliases=("SparseEmbedding",))
def _sparse_embedding(params, data, weight):
    """The lookup of ``Embedding``; its gradient is dense here, as in the
    JAX package."""
    return get_op("Embedding").fcompute(params, data, weight)
