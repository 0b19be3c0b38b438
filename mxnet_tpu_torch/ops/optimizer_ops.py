"""Optimizer update operators.

Counterpart of `mxnet_tpu/ops/optimizer_ops.py` (reference
`src/operator/optimizer_op-inl.h`): the eleven updates ``sgd_update``,
``sgd_mom_update``, ``mp_sgd_update``, ``mp_sgd_mom_update``,
``adam_update``, ``rmsprop_update``, ``rmspropalex_update``,
``ftrl_update``, ``signsgd_update``, ``signum_update`` and
``ftml_update``. This file is the one place where each update's
per-tensor arithmetic is written.

Each is a plain function over tensors that writes the weight and its
states in place under ``torch.no_grad()``, as the reference's
``kWriteInplace`` kernels do, so an update allocates no second copy of
the weights. The order of the arithmetic is the JAX package's: the
gradient in f32, times ``rescale_grad``, then clipped, then ``wd *
weight`` added (``mp_sgd*`` take that weight from the f32 master copy),
and the new weight rounded once to the weight's dtype. Python scalars
combine with each other in double precision before they meet a tensor,
as in the JAX package.

Each is also a registered op with the JAX package's ``mutate_aux``
indices, so ``nd.adam_update(w, g, m, v, out=w, lr=...)`` works as there:
the op updates the states in place and returns the new weight, written
into ``out`` when it is given (the weight itself is left alone
otherwise).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "signsgd_update",
           "signum_update", "ftml_update"]


def _grad(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight -= lr * (clip(rescale_grad * grad) + wd * weight)."""
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient) + wd * w32
        weight.copy_(w32 - lr * g)
    return weight


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * (clip(rescale_grad * grad) + wd *
    weight); weight += mom."""
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient) + wd * w32
        new_mom = momentum * mom.float() - lr * g
        mom.copy_(new_mom)
        weight.copy_(w32 + new_mom)
    return weight


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """SGD on the f32 master copy ``weight32``; the (bf16/f16) weight is
    its rounding."""
    with torch.no_grad():
        g = _grad(grad, rescale_grad, clip_gradient) + wd * weight32
        weight32.copy_(weight32 - lr * g)
        weight.copy_(weight32)
    return weight


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """SGD with momentum on the f32 master copy ``weight32``."""
    with torch.no_grad():
        g = _grad(grad, rescale_grad, clip_gradient) + wd * weight32
        new_mom = momentum * mom - lr * g
        mom.copy_(new_mom)
        weight32.copy_(weight32 + new_mom)
        weight.copy_(weight32)
    return weight


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adam; ``lr`` already carries the bias correction (the optimizer
    folds it in, as the JAX package does)."""
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient) + wd * w32
        mean.copy_(beta1 * mean + (1 - beta1) * g)
        var.copy_(beta2 * var + (1 - beta2) * g.square())
        weight.copy_(w32 - lr * mean / (var.sqrt() + epsilon))
    return weight


def mp_adam_update(weight, grad, mean, var, weight32, lr, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """Adam on the f32 master copy ``weight32`` from the gradient in f32;
    the (bf16/f16) weight is its rounding. What the optimizer's
    ``update_multi_precision`` does for Adam; not a registered op (the JAX
    package has no ``mp_adam_update``), only the multi-tensor update's
    plain version."""
    with torch.no_grad():
        adam_update(weight32, grad.float(), mean, var, lr, beta1=beta1,
                    beta2=beta2, epsilon=epsilon, wd=wd,
                    rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        weight.copy_(weight32)
    return weight


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient) + wd * w32
        n.copy_((1 - gamma1) * g.square() + gamma1 * n)
        weight.copy_(w32 - lr * g / (n + epsilon).sqrt())
    return weight


def rmspropalex_update(weight, grad, n, g_state, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """Centered RMSProp (Graves 2013)."""
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient) + wd * w32
        n.copy_((1 - gamma1) * g.square() + gamma1 * n)
        g_state.copy_((1 - gamma1) * g + gamma1 * g_state)
        delta.copy_(gamma2 * delta
                    - lr * g / (n - g_state.square() + epsilon).sqrt())
        weight.copy_(w32 + delta)
    return weight


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient)
        new_n = n + g.square()
        sigma = (new_n.sqrt() - n.sqrt()) / lr
        z.copy_(z + g - sigma * w32)
        n.copy_(new_n)
        new_w = torch.where(
            z.abs() <= lamda1, torch.zeros_like(w32),
            -(z - z.sign() * lamda1) / ((beta + new_n.sqrt()) / lr + wd))
        weight.copy_(new_w)
    return weight


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    with torch.no_grad():
        g = _grad(grad, rescale_grad, clip_gradient)
        w32 = weight.float()
        weight.copy_(w32 - lr * (g.sign() + wd * w32))
    return weight


def signum_update(weight, grad, mom, lr, momentum=0.0, wd_lh=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient) + wd * w32
        mom.copy_(momentum * mom - (1 - momentum) * g)
        weight.copy_((1 - lr * wd_lh) * w32 + lr * mom.sign())
    return weight


def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    with torch.no_grad():
        w32 = weight.float()
        g = _grad(grad, rescale_grad, clip_gradient) + wd * w32
        v.copy_(beta2 * v + (1 - beta2) * g.square())
        d_t = (1 - beta1 ** t) / lr * ((v / (1 - beta2 ** t)).sqrt()
                                       + epsilon)
        sigma = d_t - beta1 * d
        z.copy_(beta1 * z + (1 - beta1) * g - sigma * w32)
        d.copy_(d_t)
        weight.copy_(-z / d_t)
    return weight


# name -> (function, number of state inputs after weight and grad)
_UPDATES = {f.__name__: (f, n) for f, n in (
    (sgd_update, 0), (sgd_mom_update, 1), (mp_sgd_update, 1),
    (mp_sgd_mom_update, 2), (adam_update, 2), (rmsprop_update, 1),
    (rmspropalex_update, 3), (ftrl_update, 2), (signsgd_update, 0),
    (signum_update, 1), (ftml_update, 3))}


def _register(name, fn, n_states):
    def fcompute(params, weight, grad, *states):
        """The new weight (the input weight is left as it was) and the
        states, updated in place."""
        attrs = {k: v for k, v in params.items() if not k.startswith("_")}
        out = weight.detach().clone()
        fn(out, grad, *states, **attrs)
        return (out,) + tuple(states)

    fcompute.__name__ = "_" + name
    fcompute.__doc__ = fn.__doc__
    register(name, mutate_aux=tuple(range(2, 2 + n_states)) or None,
             num_outputs=1)(fcompute)


for _name, (_fn, _n) in _UPDATES.items():
    _register(_name, _fn, _n)
