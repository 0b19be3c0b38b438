"""Optimizer update operators.

Counterpart of `mxnet_tpu/ops/optimizer_ops.py` (``sgd_update``,
``sgd_mom_update``; reference `src/operator/optimizer_op-inl.h`). The
JAX package returns new arrays, since its arrays are immutable; here the
updates write the weight (and the momentum) in place under
``torch.no_grad()``, as the reference's ``kWriteInplace`` kernels do, so
an update allocates no second copy of the weights. The order of the
arithmetic is the JAX package's: rescale, then clip, then add ``wd *
weight``, all in f32.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update"]


def _grad_prep(weight, grad, wd, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight.float()


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight -= lr * (clip(rescale_grad * grad) + wd * weight), in place."""
    with torch.no_grad():
        g = _grad_prep(weight, grad, wd, rescale_grad, clip_gradient)
        weight.copy_(weight.float() - lr * g)
    return weight


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * (clip(rescale_grad * grad) + wd *
    weight); weight += mom; both in place."""
    with torch.no_grad():
        g = _grad_prep(weight, grad, wd, rescale_grad, clip_gradient)
        new_mom = momentum * mom.float() - lr * g
        mom.copy_(new_mom)
        weight.copy_(weight.float() + new_mom)
    return weight
