"""The ops of `mxnet_tpu/ops/compat_ops.py`.

The legacy aliases ``Convolution_v1`` and ``CuDNNBatchNorm`` are
registered with ``Convolution`` and ``BatchNorm`` in `ops/nn.py`. The
rest are counterparts of the JAX file's: the graph-plumbing identities
(``_copyto``, ``_CrossDeviceCopy``, ``_grad_add``,
``_identity_with_attr_like_rhs``); the sparse block (reference
`tensor/cast_storage-inl.h`, `sparse_retain.cc`, `square_sum`,
`optimizer_op.cc` ``_sparse_adagrad_update``, `indexing_op.cc`
``_contrib_SparseEmbedding``), which as in the JAX package computes on
the dense layout (the storage type is the array's, the math the same);
slice assignment; the image tensor ops; the negative-binomial
multisamplers, drawing from the op's generator as every sampler of
`ops/random_ops.py` does; and ``IdentityAttachKLSparseReg``.
"""
from __future__ import annotations

import torch

from .detection import _div
from .random_ops import _gamma, _multisample, _poisson
from .registry import get_op, register


# -- graph-plumbing identities (reference elemwise_unary_op_basic.cc,
#    cross_device_copy.cc) ---------------------------------------------------
@register("_copyto")
def _copyto(params, x):
    """A copy of ``x`` (the device is the caller's)."""
    return (x.clone(),)


@register("_CrossDeviceCopy")
def _cross_device_copy(params, x):
    """The reference's PlaceDevice pass puts these at the edges between
    device groups; one device here, so a copy."""
    return (x.clone(),)


@register("_grad_add")
def _grad_add(params, a, b):
    """The add of gradient accumulation."""
    return (a + b,)


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


# -- slice assignment (reference tensor/matrix_op.cc _slice_assign) --------
def _assign_index(params, shape, device):
    """``begin``/``end``/``step`` as one index a leading axis, negatives
    counted from the end. A negative step is not a torch slice: then
    every axis is an index tensor made on ``device`` (so a CUDA graph can
    hold it), broadcast against the others."""
    begin = tuple(params["begin"])
    end = tuple(params["end"])
    step = tuple(params.get("step", ()) or ()) or (1,) * len(begin)
    slices = []
    for b, e, st, n in zip(begin, end, step, shape):
        st = st or 1
        b = b + n if b is not None and b < 0 else b
        e = e + n if e is not None and e < 0 else e
        slices.append(slice(b, e, st))
    if all(sl.step > 0 for sl in slices):
        return tuple(slices)
    k = len(slices)
    return tuple(torch.arange(*sl.indices(n), device=device).reshape(
        (1,) * i + (-1,) + (1,) * (k - i - 1))
        for i, (sl, n) in enumerate(zip(slices, shape)))


def _assign(params, lhs, value):
    out = lhs.clone()
    out[_assign_index(params, lhs.shape, lhs.device)] = value
    return out


@register("_slice_assign", aliases=("_crop_assign",))
def _slice_assign(params, lhs, rhs):
    """``lhs`` with the slice replaced by ``rhs`` (broadcast to it)."""
    return (_assign(params, lhs, rhs.to(lhs.dtype)),)


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(params, lhs):
    return (_assign(params, lhs, params.get("scalar", 0.0)),)


# -- image frontend ops (reference src/operator/image/image_random.cc) ----
@register("_image_to_tensor", aliases=("image_to_tensor",))
def _image_to_tensor(params, x):
    """HWC (or NHWC) in [0, 255] to CHW (NCHW) f32 in [0, 1]."""
    out = x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
    return (_div(out.float(), 255.0),)


@register("_image_normalize", aliases=("image_normalize",))
def _image_normalize(params, x):
    """(x - mean) / std a channel of a CHW or NCHW input."""
    shape = (1, -1, 1, 1) if x.dim() == 4 else (-1, 1, 1)
    mean = torch.tensor(params.get("mean", (0.0,)), dtype=x.dtype,
                        device=x.device).reshape(shape)
    std = torch.tensor(params.get("std", (1.0,)), dtype=x.dtype,
                       device=x.device).reshape(shape)
    return ((x - mean) / std,)


# -- negative-binomial multisamplers (reference multisample_op.cc) --------
_multisample("_sample_negative_binomial", lambda g, a, s, d: _poisson(
    _gamma(a[0], s, g, d) * ((1 - a[1]) / a[1]), g))


def _gen_negbin(g, a, s, d):
    """Poisson with a Gamma(1/alpha, mu*alpha) rate; Poisson(mu) where
    alpha is 0."""
    mu, alpha = a[0].expand(s), a[1].expand(s)
    gam = _gamma(1.0 / alpha.clamp_min(1e-8), s, g, d)
    return _poisson(torch.where(alpha > 0, gam * mu * alpha, mu), g)


_multisample("_sample_generalized_negative_binomial", _gen_negbin)


# -- IdentityAttachKLSparseReg (reference
#    identity_attach_KL_sparse_reg-inl.h) ------------------------------------
class _AttachPenalty(torch.autograd.Function):
    """The identity, whose gradient gains ``penalty``."""

    @staticmethod
    def forward(ctx, x, penalty):
        ctx.save_for_backward(penalty)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        penalty, = ctx.saved_tensors
        return g + penalty, None


@register("IdentityAttachKLSparseReg", mutate_aux=(1,),
          need_train_flag=True)
def _identity_attach_kl_sparse_reg(params, data, moving_avg):
    """The identity; in training the moving average of the mean
    activation steps, and the gradient gains the KL sparseness penalty
    at the updated average (no 1/N), as the reference's backward
    reads it."""
    rho = params.get("sparseness_target", 0.1)
    momentum = params.get("momentum", 0.9)
    with torch.no_grad():
        new_avg = moving_avg
        if params.get("_is_train", False):
            new_avg = momentum * moving_avg + (1.0 - momentum) \
                * data.mean(dim=0)
        rho_hat = new_avg.clamp(1e-6, 1 - 1e-6)
        penalty = params.get("penalty", 0.001) * (
            -rho / rho_hat + (1 - rho) / (1 - rho_hat))
    return (_AttachPenalty.apply(data, penalty), new_avg)
