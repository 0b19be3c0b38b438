"""Optimizers.

Counterpart of `mxnet_tpu/optimizer.py` (reference
`python/mxnet/optimizer.py`), cut to what the LSTM training slice runs:
the ``Optimizer`` base (lr/wd, ``lr_mult``/``wd_mult`` by index, by name
and from symbol attributes, ``rescale_grad``, ``clip_gradient``,
``num_update`` and the lr-scheduler hook), ``SGD`` with and without
momentum, ``Updater``, ``get_updater``, ``create`` and ``register``. The
update itself is ``ops/optimizer_ops.py``, in place on the weight. The
JAX package's ``FusedApplier`` compiles every parameter's update into one
program; the port applies them one by one, eagerly. Multi-precision and
the other optimizers wait for a later slice.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from .ops.optimizer_ops import sgd_mom_update, sgd_update

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create",
           "register"]


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
        if multi_precision:
            raise MXNetError("multi_precision is not ported yet: the port "
                             "trains f32 weights")
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
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise ValueError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

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


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with optional momentum (reference optimizer.py SGD)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return NDArray(torch.zeros(weight.shape, dtype=torch.float32,
                                       device=weight.data.device),
                           weight.context)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is not None:
            sgd_mom_update(weight.data, grad.data, state.data,
                           momentum=self.momentum, **kw)
        else:
            sgd_update(weight.data, grad.data, **kw)


class Updater:
    """Applies an optimizer to indexed weights (reference Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return Optimizer.create_optimizer(name, **kwargs)
