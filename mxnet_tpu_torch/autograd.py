"""Imperative autograd: the training and recording flags, and the tape.

Counterpart of `mxnet_tpu/autograd.py` (reference
`python/mxnet/autograd.py`): ``is_training``/``is_recording`` and the
scopes ``record``, ``pause``, ``train_mode`` and ``predict_mode``, per
thread, and the tape functions ``backward``, ``grad``,
``mark_variables`` and ``Function``.

The tape is ``torch.autograd``. Under ``record()`` an op with an input
that requires a gradient runs with grad enabled (`ops/invoke.py`), so the
NDArray it returns carries a tensor with a ``grad_fn``; every other op
runs under ``torch.no_grad()``. ``NDArray.attach_grad`` and
:func:`mark_variables` make an array's tensor a leaf that requires grad
and give it a gradient slot: the NDArray that receives its gradient and
the ``grad_req``. :func:`backward` is ``torch.autograd.backward`` with
ones as the default head gradient; a hook that runs as each leaf's
gradient is accumulated moves it into the slot (``write`` copies,
``add`` adds, ``null`` drops it), in the leaf's dtype, and clears the
leaf's own ``.grad``. :func:`grad` is ``torch.autograd.grad``; with
``create_graph=True`` its results are on the tape themselves, the sweep
that the JAX package's ``_grad_taped`` builds by hand. :class:`Function`
runs a user's ``forward`` and ``backward`` over NDArrays as a
``torch.autograd.Function``.

The JAX package's arrays are immutable, so a recorded op keeps its
inputs as they were at record time. Torch saves the tensors themselves:
the writes that touch leaves (the optimizer's update, ``set_data``, the
initializer, ``arr[:] = v``) run under ``torch.no_grad()``, and a
backward through a graph one of whose saved tensors was written since it
was recorded raises :class:`MXNetError` (take the gradient before the
write). A second backward through a freed graph raises it too.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "get_symbol", "Function"]

_GRAD_REQS = ("write", "add", "null")


class _State(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False


_STATE = _State()


class _Scope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training
        self._saved = None

    def __enter__(self):
        self._saved = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._saved
        return False


def record(train_mode=True):
    """``with autograd.record():`` sets recording and (by default)
    training for its body."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    """Set the recording flag; returns the previous one."""
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag):
    """Set the training flag; returns the previous one."""
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


# ---------------------------------------------------------------------------
# leaves and their gradient slots
# ---------------------------------------------------------------------------
class _GradSlot:
    """Where a leaf's gradient goes: ``grad`` (an NDArray) by ``req``."""

    __slots__ = ("grad", "req")

    def __init__(self, grad, req):
        self.grad = grad
        self.req = req


def _land(leaf):
    """Post-accumulate hook of a leaf: move its gradient into its slot."""
    g, leaf.grad = leaf.grad, None
    slot = leaf._mx_grad_slot
    if g is None or slot.grad is None or slot.req == "null":
        return
    dst = slot.grad.data
    with torch.no_grad():
        if slot.req == "add":
            dst.add_(g.to(dst.dtype))
        else:
            dst.copy_(g)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable's tensor a leaf that requires grad, with its
    gradient landing in the matching NDArray of ``gradients`` by
    ``grad_reqs`` (one string, or one per variable). An array computed on
    the tape is cut from it first (its values stay, its history goes)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in _GRAD_REQS:
            raise MXNetError("grad_req must be one of %s, got %r"
                             % (_GRAD_REQS, req))
        t = var.data
        slot = getattr(t, "_mx_grad_slot", None)
        if slot is None or not t.is_leaf:
            if not (t.is_floating_point() or t.is_complex()):
                raise MXNetError("only floating-point arrays take a "
                                 "gradient; this one is %s" % t.dtype)
            t = t.detach() if not t.is_leaf or t.requires_grad else t
            t.requires_grad_(True)
            slot = t._mx_grad_slot = _GradSlot(None, "write")
            t.register_post_accumulate_grad_hook(_land)
            var._data = t
        slot.grad = g
        slot.req = req


# ---------------------------------------------------------------------------
# backward and grad
# ---------------------------------------------------------------------------
def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    if len(heads) != len(head_grads):
        raise MXNetError("heads and head_grads length mismatch")
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h.data
        if not t.requires_grad:
            continue
        outs.append(t)
        cots.append(torch.ones_like(t) if hg is None
                    else hg.data.to(t.device, t.dtype))
    if not outs:
        raise MXNetError(
            "this array is not attached to any computation graph; run "
            "operations inside autograd.record() first")
    return outs, cots


def _tape_error(exc):
    """torch's errors about the tape, in the JAX package's words."""
    msg = str(exc)
    if "backward through the graph a second time" in msg:
        return MXNetError(
            "computation graph was already freed by a previous backward; "
            "pass retain_graph=True to backward() to keep it")
    if "modified by an inplace operation" in msg:
        return MXNetError(
            "an array the recorded graph reads was written in place after "
            "it was recorded (an optimizer step, set_data or arr[:] = v); "
            "take the gradient before writing into the tape's inputs (%s)"
            % msg)
    return None


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run backward from ``heads`` (ones as each head's gradient unless
    ``head_grads`` gives one) into the gradient slots of the leaves they
    reach, honouring each slot's ``grad_req``."""
    outs, cots = _heads(heads, head_grads)
    with _Scope(None, train_mode):
        try:
            torch.autograd.backward(outs, cots, retain_graph=retain_graph)
        except RuntimeError as exc:
            err = _tape_error(exc)
            if err is None:
                raise
            raise err from exc


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    (not written into any slot); a variable the heads do not reach gets
    zeros. With ``create_graph=True`` the results are on the tape, so a
    later ``backward``/``grad`` differentiates through them."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    variables = [variables] if single else list(variables)
    outs, cots = _heads(heads, head_grads)
    wrt = [v for v in variables if v.data.requires_grad]
    found = {}
    if wrt:
        with _Scope(None, train_mode):
            try:
                gs = torch.autograd.grad(
                    outs, [v.data for v in wrt], cots,
                    retain_graph=retain_graph, create_graph=create_graph,
                    allow_unused=True)
            except RuntimeError as exc:
                err = _tape_error(exc)
                if err is None:
                    raise
                raise err from exc
        found = {id(v): g for v, g in zip(wrt, gs)}
    result = []
    for v in variables:
        g = found.get(id(v))
        if g is None:
            g = torch.zeros_like(v.data, requires_grad=False)
        result.append(NDArray(g, v.context))
    return result[0] if single else result


def get_symbol(x):
    raise NotImplementedError("autograd.get_symbol: use Symbol tracing "
                              "instead")


# ---------------------------------------------------------------------------
# custom functions
# ---------------------------------------------------------------------------
class _FunctionNode(torch.autograd.Function):
    """One call of a user's :class:`Function` on the tape."""

    @staticmethod
    def forward(ctx, fn, contexts, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            out = fn.forward(*[NDArray(t, c)
                               for t, c in zip(tensors, contexts)])
        single = isinstance(out, NDArray)
        outs = [out] if single else list(out)
        ctx.fn = fn
        ctx.out_contexts = fn._out_contexts = [o.context for o in outs]
        fn._single = single
        return tuple(o.data for o in outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            in_grads = ctx.fn.backward(*[NDArray(g, c) for g, c in
                                         zip(grads, ctx.out_contexts)])
        if isinstance(in_grads, NDArray):
            in_grads = [in_grads]
        return (None, None) + tuple(None if g is None else g.data
                                    for g in in_grads)


class Function:
    """A differentiable function written by the user (reference
    autograd.py ``Function``): subclass it and implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` over
    NDArrays; ``backward`` returns one gradient per input. Both run with
    recording paused. A Function's backward is not differentiated again
    (``create_graph`` through it raises, as in the JAX package)."""

    def __init__(self):
        self._saved = ()
        self._single = True
        self._out_contexts = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (is_recording() and any(x.data.requires_grad
                                       for x in inputs)):
            with pause():
                return self.forward(*inputs)
        outs = _FunctionNode.apply(self, [x.context for x in inputs],
                                   *[x.data for x in inputs])
        nds = [NDArray(o, c) for o, c in zip(outs, self._out_contexts)]
        return nds[0] if self._single else nds
