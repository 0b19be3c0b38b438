"""Gluon Trainer.

Counterpart of `mxnet_tpu/gluon/trainer.py` (reference
`python/mxnet/gluon/trainer.py`): an optimizer applied to a list (or
``ParameterDict``) of parameters. The single-process path of the JAX
package's ``_init_kvstore``: ``kvstore=None``, or any kvstore name
without ``dist`` (``"device"``, ``"local"``), means no kvstore and no
gradient synchronisation, so ``allreduce_grads`` does nothing. A
``dist*`` name or a KVStore object raises: distributed training is not
ported yet (ROADMAP.md, queue A item 10). ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``rescale_grad / batch_size`` and
updates every parameter whose ``grad_req`` is not ``null`` in place, all
in one call of ``optimizer.FusedApplier`` (one launch of the
multi-tensor kernel a (formula, dtype) group on the card, for SGD and
Adam). ``save_states``/``load_states`` write and read the updater's
states with the optimizer (its update counts, which Adam's bias
correction reads); a loaded optimizer replaces the Trainer's, as in the
reference, so a fresh Trainer resumes where the saved one stopped.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s."
                                 % type(param))
            self._params.append(param)
        if kvstore is not None and not (isinstance(kvstore, str)
                                        and "dist" not in kvstore):
            raise MXNetError(
                "kvstore %r: distributed training is not ported yet "
                "(ROADMAP.md, queue A item 10); pass kvstore=None or a "
                "single-process name such as 'device'" % (kvstore,))
        if compression_params or update_on_kvstore:
            raise MXNetError("gradient compression and update_on_kvstore "
                             "need a distributed kvstore, which is not "
                             "ported yet")
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore = None
        self._update_on_kvstore = False

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]
        self._fused = None

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every parameter from its gradient, the gradients
        scaled by ``1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """Sum the gradients across workers: nothing to do in one
        process."""

    def update(self, batch_size, ignore_stale_grad=False):
        """``step`` without the gradient synchronisation."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        if self._fused is None:
            self._fused = opt.FusedApplier.resolve(self._updaters[0])
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if live:
            self._fused([i for i, _ in live], [p.data() for _, p in live],
                        [p.grad() for _, p in live])

    def save_states(self, fname):
        """Write the optimizer's states, and the optimizer, to ``fname``."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read a ``save_states`` file: the states, and the optimizer it
        holds, which becomes this Trainer's."""
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read())
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._fused = None
