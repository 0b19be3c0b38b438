"""Optimizers.

Counterpart of `mxnet_tpu/optimizer.py` (reference
`python/mxnet/optimizer.py`): the ``Optimizer`` base (lr and wd,
``lr_mult``/``wd_mult`` by index, by name and from symbol attributes,
``rescale_grad``, ``clip_gradient``, update counts, an lr scheduler,
``multi_precision`` with an f32 master copy of bf16/f16 weights), the
thirteen optimizers of the JAX package (``SGD``, ``NAG``, ``Signum``,
``Adam``, ``AdaGrad``, ``AdaDelta``, ``RMSProp``, ``Ftrl``, ``FTML``,
``DCASGD``, ``SGLD``, ``LBSGD``, ``Test``), ``Updater`` with its state
files, and ``FusedApplier``, the one update path of ``Module`` and
``gluon.Trainer``. A compact row-sparse gradient
(`ndarray/sparse.py`) takes the lazy update of ``SGD``, ``Adam`` (unless
``lazy_update=False``) and ``AdaGrad``: only its rows of the weight and
states change, in one launch of S1 on the card
(`ops/sparse_update.py`); every other update reads a gradient's dense
view (``_data``).

The per-tensor arithmetic of every optimizer that has an update op is
`ops/optimizer_ops.py`, in place on the weight and its states; the others
(NAG, AdaGrad, AdaDelta, DCASGD, SGLD, Test) are written over NDArrays,
as in the JAX package. ``FusedApplier`` updates SGD (every variant) and
Adam with one launch of the multi-tensor kernel (`ops/multi_tensor.py`)
per (formula, weight dtype) group on the card, and applies any other
optimizer index by index inside the same call.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .context import cpu
from .ndarray.ndarray import NDArray
from .ops.multi_tensor import UpdateBuffers, multi_tensor_update
from .ops.optimizer_ops import (adam_update, ftml_update, ftrl_update,
                                mp_sgd_mom_update, mp_sgd_update,
                                rmsprop_update, rmspropalex_update,
                                sgd_mom_update, sgd_update, signsgd_update,
                                signum_update)
from .ops.registry import get_op
from .ops.sparse_update import sparse_row_update

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "Adam", "AdaGrad",
           "AdaDelta", "FusedApplier", "RMSProp", "Ftrl", "FTML", "DCASGD",
           "LBSGD", "SGLD", "Test", "Updater", "get_updater", "create",
           "register"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _state_zeros(weight, dtype=None):
    """Zeros of the weight's shape on its device (``dtype`` or the
    weight's)."""
    dt = torch_dtype(dtype) if dtype is not None else weight.data.dtype
    return NDArray(torch.zeros(weight.shape, dtype=dt,
                               device=weight.data.device), weight.context)


def _is_lazy_rowsparse(grad):
    """Whether ``grad`` is row-sparse and still carries its compact
    payload: the state the lazy row updates take."""
    from .ndarray.sparse import RowSparseNDArray
    return isinstance(grad, RowSparseNDArray) and grad.has_compact()


def _sparse_row_update(kind, weight, grad, states, scalars):
    """The lazy row update of ``kind`` over a compact row-sparse gradient
    (reference `src/operator/optimizer_op.cc` SGDUpdateRspImpl,
    AdamUpdateRspImpl, AdagradUpdateRspImpl): only the gradient's rows of
    ``weight`` and of ``states`` (NDArrays) change, in place. The work
    scales with nnz, not with the weight's rows."""
    vals, idx = grad.compact()
    dev = weight.data.device
    sparse_row_update(kind, weight.data, vals.to(dev), idx.to(dev),
                      tuple(s.data for s in states), **scalars)


class Optimizer:
    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise ValueError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}

    def __getstate__(self):
        # the Parameters stay out of a state file (reference optimizer.py);
        # the Trainer that loads it sets them again
        state = self.__dict__.copy()
        state["param_dict"] = {}
        return state

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, an f32 master copy of a bf16/f16
        weight beside the optimizer's own state: ``(weight32, state)``."""
        if self.multi_precision and weight.data.dtype in _LOW_PRECISION:
            weight32 = weight.astype("float32")
            return (weight32, self.create_state(index, weight32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if _is_master(self, weight, state):
            weight32, inner = state
            self.update(index, weight32, grad.astype("float32"), inner)
            weight[:] = weight32
        else:
            self.update(index, weight, grad, state)

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already "
                              "been defined.")
        self.lr = lr

    def _mults_from_symbol(self, key):
        out = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and key in attr[name]:
                    out[name] = float(attr[name][key])
        return out

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._mults_from_symbol("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(self._mults_from_symbol("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, mults, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in mults:
            return mults[index]
        if index in self.idx2name:
            return mults.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _common_kwargs(self, index):
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient:
            kw["clip_gradient"] = self.clip_gradient
        return kw


def _is_master(opt, weight, state):
    """Whether ``state`` is ``(f32 master copy, inner state)`` of a
    low-precision weight under ``multi_precision``."""
    return opt.multi_precision and isinstance(state, tuple) \
        and len(state) == 2 and isinstance(state[0], NDArray) \
        and state[0].data.dtype == torch.float32 \
        and weight.data.dtype != torch.float32


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum and multi-precision (reference optimizer.py
    SGD)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _state_zeros(weight, "float32")
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if self.lazy_update and _is_lazy_rowsparse(grad):
            if state is not None:
                kw["momentum"] = self.momentum
                _sparse_row_update("sgd_mom", weight, grad, (state,), kw)
            else:
                _sparse_row_update("sgd", weight, grad, (), kw)
            return
        if state is not None:
            sgd_mom_update(weight.data, grad._data, state.data,
                           momentum=self.momentum, **kw)
        else:
            sgd_update(weight.data, grad._data, **kw)

    def update_multi_precision(self, index, weight, grad, state):
        if not _is_master(self, weight, state):
            self.update(index, weight, grad, state)
            return
        weight32, mom = state
        self._update_count(index)
        kw = self._common_kwargs(index)
        if mom is not None:
            mp_sgd_mom_update(weight.data, grad._data, mom.data, weight32.data,
                              momentum=self.momentum, **kw)
        else:
            mp_sgd_update(weight.data, grad._data, weight32.data, **kw)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference optimizer.py NAG)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        g = g + wd * weight
        if state is not None:
            state[:] = self.momentum * state + g
            weight[:] = weight - lr * (self.momentum * state + g)
        else:
            weight[:] = weight - lr * g


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _state_zeros(weight, "float32")
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is not None:
            signum_update(weight.data, grad._data, state.data,
                          momentum=self.momentum, wd_lh=self.wd_lh, **kw)
        else:
            signsgd_update(weight.data, grad._data, **kw)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_state_zeros(weight, "float32"),
                _state_zeros(weight, "float32"))

    def _corrected_lr(self, index, lr):
        """``lr`` with the bias correction at this index's update count,
        in double precision."""
        t = self._index_update_count[index]
        return lr * math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw["lr"] = self._corrected_lr(index, kw["lr"])
        mean, var = state
        if self.lazy_update and _is_lazy_rowsparse(grad):
            kw.update(beta1=self.beta1, beta2=self.beta2,
                      epsilon=self.epsilon)
            _sparse_row_update("adam", weight, grad, (mean, var), kw)
            return
        adam_update(weight.data, grad._data, mean.data, var.data,
                    beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon, **kw)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _state_zeros(weight, "float32")

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        if _is_lazy_rowsparse(grad):
            kw = {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad,
                  "epsilon": self.float_stable_eps}
            if self.clip_gradient is not None:
                kw["clip_gradient"] = self.clip_gradient
            _sparse_row_update("adagrad", weight, grad, (state,), kw)
            return
        g = grad.astype("float32") * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        g = g + wd * weight.astype("float32")
        state[:] = state + g * g
        weight[:] = weight.astype("float32") - \
            lr * g / (state.sqrt() + self.float_stable_eps)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_state_zeros(weight), _state_zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1. - self.rho) * g * g
        current_delta = ((acc_delta + self.epsilon).sqrt()
                         / (acc_g + self.epsilon).sqrt()) * g
        acc_delta[:] = self.rho * acc_delta \
            + (1. - self.rho) * current_delta * current_delta
        weight[:] = weight - current_delta - wd * weight


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_state_zeros(weight, "float32") for _ in range(3))
        return _state_zeros(weight, "float32")

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw.update(gamma1=self.gamma1, epsilon=self.epsilon)
        if self.centered:
            n, g, delta = state
            rmspropalex_update(weight.data, grad._data, n.data, g.data,
                               delta.data, gamma2=self.gamma2, **kw)
        else:
            rmsprop_update(weight.data, grad._data, state.data, **kw)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_state_zeros(weight, "float32"),
                _state_zeros(weight, "float32"))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        ftrl_update(weight.data, grad._data, z.data, n.data,
                    lamda1=self.lamda1, beta=self.beta,
                    **self._common_kwargs(index))


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_state_zeros(weight, "float32") for _ in range(3))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        d, v, z = state
        ftml_update(weight.data, grad._data, d.data, v.data, z.data,
                    beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon,
                    t=self._index_update_count[index],
                    **self._common_kwargs(index))


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference optimizer.py DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_state_zeros(weight), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        mom, previous_weight = state
        delta = -lr * (g + wd * weight
                       + self.lamda * g * g * (weight - previous_weight))
        if mom is not None:
            mom[:] = self.momentum * mom + delta
            delta = mom
        previous_weight[:] = weight
        weight[:] = weight + delta


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics."""

    def update(self, index, weight, grad, state):
        from .ndarray import random as nd_random
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        weight[:] = weight - lr / 2 * (g + wd * weight) + nd_random.normal(
            0, math.sqrt(lr), shape=weight.shape, ctx=weight.context,
            dtype="float32").astype(weight.data.dtype)


@register
class LBSGD(SGD):
    """Large-batch SGD with LARS-style layer-wise adaptation
    (reference optimizer.py LBSGD)."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.adaptive = True

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        if self.adaptive:
            wnorm = float(weight.norm().asscalar())
            gnorm = float(grad.norm().asscalar()) * self.rescale_grad
            if wnorm > 0 and gnorm > 0:
                lr = lr * 0.001 * wnorm / (gnorm + wd * wnorm)
        kw = {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad}
        if self.clip_gradient:
            kw["clip_gradient"] = self.clip_gradient
        if state is not None:
            sgd_mom_update(weight.data, grad._data, state.data,
                           momentum=self.momentum, **kw)
        else:
            sgd_update(weight.data, grad._data, **kw)


@register
class Test(Optimizer):
    def create_state(self, index, weight):
        return _state_zeros(weight)

    def update(self, index, weight, grad, state):
        weight[:] = weight + grad * self.rescale_grad
        state[:] = weight


def _map_state(fn, s):
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(_map_state(fn, x) for x in s)
    return fn(s)


class Updater:
    """Applies an optimizer to indexed weights (reference optimizer.py
    Updater). States read from a file (``set_states``) land on the CPU
    and move to their weight's device at its next update
    (``states_synced``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def state_of(self, index, weight):
        """The index's state, created at its first update and moved to
        the weight's device after a ``set_states``."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = _map_state(
                lambda s: s.as_in_context(weight.context), self.states[index])
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.state_of(index, weight))

    def set_states(self, states):
        """Read a ``get_states`` pickle: ``{index: numpy arrays}``, or
        ``(that, optimizer)``, which then replaces the optimizer."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        from .ndarray import array as nd_array
        self.states = {k: _map_state(
            lambda s: nd_array(s, ctx=cpu(), dtype=s.dtype)
            if isinstance(s, np.ndarray) else s, v)
            for k, v in states.items()}
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states as a pickle of numpy arrays, with the optimizer when
        ``dump_optimizer``; the JAX package reads and writes the same
        format."""
        states = {k: _map_state(lambda s: s.asnumpy()
                                if isinstance(s, NDArray) else s, v)
                  for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)


def get_updater(optimizer):
    return Updater(optimizer)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return Optimizer.create_optimizer(name, **kwargs)


class FusedApplier:
    """Apply an optimizer to many parameters in one call: the one update
    path of ``Module`` and ``gluon.Trainer``.

    Counterpart of the JAX package's ``FusedApplier``, which traces the
    update ops of every parameter into one compiled program. Here SGD
    (with or without momentum, with or without ``multi_precision``) and
    Adam update every parameter of a (formula, weight dtype) group with
    one call of ``ops.multi_tensor.multi_tensor_update``: one launch of
    the multi-tensor kernel on the card, the formula's plain per-tensor
    function on the CPU. The learning rates and weight decays (Adam's
    bias correction folded into the lr, in double precision) go to the
    kernel as a vector filled each step, as the JAX package feeds them to
    its program as traced inputs. Every other optimizer, and Adam's
    ``multi_precision`` on a bf16/f16 weight off the card, is applied
    index by index through its ``update_multi_precision`` inside the same
    call. Each index's update count moves once a call. States are the
    wrapped ``Updater``'s, so its state files hold them.
    """

    def __init__(self, updater):
        self.updater = updater
        self._buffers = {}

    @property
    def optimizer(self):
        return self.updater.optimizer

    @staticmethod
    def supports(optimizer):
        """Whether the optimizer's update has a formula of the
        multi-tensor kernel."""
        return type(optimizer) in (SGD, Adam)

    @classmethod
    def resolve(cls, updater):
        """The FusedApplier over ``updater``: the single resolution point
        of every caller that caches a ``_fused`` attribute."""
        if not isinstance(updater, Updater):
            raise MXNetError("FusedApplier wraps an optimizer.Updater, got "
                             "%s" % type(updater).__name__)
        return cls(updater)

    def formula(self, weight, state):
        """The kernel formula of one index, or None for the per-index
        path."""
        opt = self.optimizer
        if not self.supports(opt):
            return None
        if type(opt) is Adam:
            return None if _is_master(opt, weight, state) else "adam"
        if _is_master(opt, weight, state):
            return "mp_sgd" if state[1] is None else "mp_sgd_mom"
        return "sgd" if state is None else "sgd_mom"

    def _kernel_states(self, index):
        """The index's states in the order of its formula's function in
        `ops/optimizer_ops.py` (``mp_sgd_mom``: momentum, then master)."""
        s = self.updater.states[index]
        if s is None:
            return ()
        if isinstance(s, tuple) and isinstance(self.optimizer, SGD):
            master, mom = s
            return (master,) if mom is None else (mom, master)
        return s if isinstance(s, tuple) else (s,)

    def prepare(self, indices, weights):
        """Host bookkeeping of one call for the indices the kernel takes:
        their states (created, or moved after a ``set_states``), their
        update counts moved once, and their lrs and wds. Returns (lrs,
        wds, rescale_grad, states), each index's states in
        ``_kernel_states``'s order."""
        opt = self.optimizer
        for i, w in zip(indices, weights):
            self.updater.state_of(i, w)
            opt._update_count(i)
        lrs, wds = [], []
        for i in indices:
            lr = opt._get_lr(i)
            lrs.append(opt._corrected_lr(i, lr) if isinstance(opt, Adam)
                       else lr)
            wds.append(opt._get_wd(i))
        return lrs, wds, opt.rescale_grad, [self._kernel_states(i)
                                            for i in indices]

    def update_op(self, formula=None):
        """(op name, fcompute, static attributes) of the registered update
        op of ``formula`` (by default the optimizer's f32 one): the
        building block of a caller that fuses the update itself."""
        opt = self.optimizer
        if formula is None:
            formula = "adam" if isinstance(opt, Adam) else \
                ("sgd_mom" if opt.momentum != 0.0 else "sgd")
        static = {"clip_gradient": opt.clip_gradient or -1.0}
        static.update(self._constants())
        op_name = formula + "_update"
        return op_name, get_op(op_name).fcompute, static

    def _constants(self):
        opt = self.optimizer
        if isinstance(opt, Adam):
            return {"beta1": opt.beta1, "beta2": opt.beta2,
                    "epsilon": opt.epsilon}
        return {"momentum": opt.momentum}

    def commit_states(self, indices, new_states):
        """Copy new state values (tuples in ``prepare``'s order) into the
        updater's states in place, so that their addresses hold."""
        with torch.no_grad():
            for i, new in zip(indices, new_states):
                for old, value in zip(self._kernel_states(i), new):
                    value = value.data if isinstance(value, NDArray) \
                        else value
                    if old.data is not value:
                        old.data.copy_(value)

    def __call__(self, indices, weights, grads):
        opt = self.optimizer
        groups, rest = {}, []
        for i, w, g in zip(indices, weights, grads):
            formula = self.formula(w, self.updater.state_of(i, w))
            if formula is None:
                if w.data.is_cuda and self.supports(opt):
                    raise MXNetError(
                        "%s with multi_precision on a %s weight has no "
                        "formula of the multi-tensor kernel"
                        % (type(opt).__name__, w.data.dtype))
                rest.append((i, w, g))
            else:
                groups.setdefault((formula, w.data.dtype, w.data.device),
                                  []).append((i, w, g))
        for key, items in groups.items():
            idx = [i for i, _, _ in items]
            ws = [w for _, w, _ in items]
            lrs, wds, rescale, states = self.prepare(idx, ws)
            multi_tensor_update(
                key[0], [w.data for w in ws], [g._data for _, _, g in items],
                [tuple(s.data for s in st) for st in states], lrs, wds,
                rescale_grad=rescale, clip_gradient=opt.clip_gradient or -1.0,
                buffers=self._buffers.setdefault(key, UpdateBuffers()),
                **self._constants())
        for i, w, g in rest:
            opt.update_multi_precision(i, w, g, self.updater.state_of(i, w))
