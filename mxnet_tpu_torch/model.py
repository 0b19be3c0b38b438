"""Model checkpoints.

Counterpart of `mxnet_tpu/model.py` (reference `python/mxnet/model.py`
save_checkpoint:365, load_checkpoint:395): ``prefix-symbol.json`` (the
graph JSON) and ``prefix-%04d.params`` (the named arrays with ``arg:`` and
``aux:`` prefixes, in the ``.params`` format both packages read and
write), and the legacy ``FeedForward`` API as a shim over ``Module``.
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod
from .context import gpu, scope_context
from .module.base_module import BatchEndParam

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward",
           "BatchEndParam"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params), the arrays on the current
    context."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch)).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API (reference model.py FeedForward) over a
    ``Module``. ``ctx=None`` is the enclosing ``with ctx:`` scope's
    context when the model is made, else gpu(0), as for ``Module``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else (scope_context() or gpu(0))
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _get_module(self, data_names=("data",),
                    label_names=("softmax_label",)):
        from .module import Module
        if self._module is None:
            self._module = Module(self.symbol, data_names=data_names,
                                  label_names=label_names, context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train ``num_epoch`` epochs on ``X`` (a DataIter, or arrays with
        labels ``y``, shuffled in batches of ``numpy_batch_size``)."""
        from . import io as io_mod
        if not isinstance(X, io_mod.DataIter):
            X = io_mod.NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                                   shuffle=True)
        label_names = [d.name for d in (X.provide_label or [])] \
            or ["softmax_label"]
        mod = self._get_module(label_names=tuple(label_names))
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self.kwargs.get(
                    "optimizer_params", (("learning_rate", 0.01),)),
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as a numpy array."""
        from . import io as io_mod
        if not isinstance(X, io_mod.DataIter):
            X = io_mod.NDArrayIter(X, batch_size=self.numpy_batch_size)
        mod = self._get_module()
        if not mod.binded:
            mod.bind(data_shapes=X.provide_data, label_shapes=None,
                     for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=False)
        out = mod.predict(X, num_batch=num_batch, reset=reset)
        return out.asnumpy() if hasattr(out, "asnumpy") else out

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)
