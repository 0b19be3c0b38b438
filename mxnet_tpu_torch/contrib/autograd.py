"""The legacy imperative autograd API (counterpart of
`mxnet_tpu/contrib/autograd.py`, reference
`python/mxnet/contrib/autograd.py`): adapters over the port's tape
(`autograd.py`, on ``torch.autograd``) for scripts written against the
old contrib surface.
"""
from __future__ import annotations

import functools

from .. import autograd as _ag

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad"]


def set_is_training(is_train):
    """Set training mode + recording (reference contrib/autograd.py:32
    couples both). Returns the previous recording state."""
    prev = _ag.set_recording(is_train)
    _ag.set_training(is_train)
    return prev


class TrainingStateScope(object):
    def __init__(self, enter_state):
        self._enter_state = enter_state
        self._prev_rec = None
        self._prev_train = None

    def __enter__(self):
        self._prev_rec = _ag.set_recording(self._enter_state)
        self._prev_train = _ag.set_training(self._enter_state)

    def __exit__(self, ptype, value, trace):
        _ag.set_recording(self._prev_rec)
        _ag.set_training(self._prev_train)


def train_section():
    """with autograd.train_section(): ... (reference :74)"""
    return TrainingStateScope(True)


def test_section():
    """with autograd.test_section(): ... inside a train section."""
    return TrainingStateScope(False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to NDArrays (reference :102)."""
    if not isinstance(variables, (list, tuple)):
        variables = [variables]
        gradients = [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        var.attach_grad(grad_req=req)
        if req != "null":
            var.grad[:] = grad


def backward(outputs, out_grads=None, retain_graph=False):
    """Backprop on marked variables (reference :123)."""
    _ag.backward(outputs, head_grads=out_grads, retain_graph=retain_graph)


def compute_gradient(outputs):
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Decorate `func` to return (gradients, outputs) (reference :163)."""
    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = argnum if isinstance(argnum, list) else [argnum]
            variables = [args[i] for i in argnums]
        for x in variables:
            x.attach_grad()
        with _ag.record():
            outputs = func(*args)
        _ag.backward(outputs if isinstance(outputs, list) else [outputs])
        return [x.grad for x in variables], outputs
    return wrapped


def grad(func, argnum=None):
    """Decorate `func` to return gradients only (reference :195)."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
