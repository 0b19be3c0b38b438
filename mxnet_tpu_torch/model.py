"""Model checkpoints.

Counterpart of `mxnet_tpu/model.py` (reference `python/mxnet/model.py`
save_checkpoint:365, load_checkpoint:395): ``prefix-symbol.json`` (the
graph JSON) and ``prefix-%04d.params`` (the named arrays with ``arg:`` and
``aux:`` prefixes, in the ``.params`` format both packages read and
write). The legacy ``FeedForward`` API is not ported.
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod
from .module.base_module import BatchEndParam

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]


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
