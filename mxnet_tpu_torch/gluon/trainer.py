"""Gluon Trainer.

Counterpart of `mxnet_tpu/gluon/trainer.py` (reference
`python/mxnet/gluon/trainer.py`): an optimizer applied to a list (or
``ParameterDict``) of parameters. The single-process paths of the JAX
package's ``_init_kvstore``, run at the first ``step``,
``allreduce_grads``, ``update`` or state file: ``kvstore=None``, or any
kvstore name without ``dist`` (``"device"``, ``"local"``), means no
kvstore (``update_on_kvstore`` is then ignored, as in the JAX package),
so ``allreduce_grads`` does nothing. A ``KVStore`` object (`kvstore.py`)
gets every parameter's key, and by default the optimizer: ``step`` then
pushes each gradient and pulls each weight back from the store; with
``update_on_kvstore=False`` it pulls the summed gradients back and
updates here. A ``dist*`` name raises: distributed training is not
ported yet (ROADMAP.md, queue A item 10). ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``rescale_grad / batch_size`` and,
without a store that updates, updates every parameter whose ``grad_req``
is not ``null`` in place, all in one call of ``optimizer.FusedApplier``
(one launch of the multi-tensor kernel a (formula, dtype) group on the
card, for SGD and Adam). ``save_states``/``load_states`` write and read the updater's
states with the optimizer (its update counts, which Adam's bias
correction reads); a loaded optimizer replaces the Trainer's, as in the
reference, so a fresh Trainer resumes where the saved one stopped.
"""
from __future__ import annotations

from .. import kvstore as kvs
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
        if isinstance(kvstore, str) and "dist" in kvstore:
            raise MXNetError(
                "kvstore %r: distributed training is not ported yet "
                "(ROADMAP.md, queue A item 10); pass kvstore=None, a "
                "single-process name such as 'device' or a KVStore"
                % (kvstore,))
        if not (kvstore is None or isinstance(kvstore, (str, kvs.KVStore))):
            raise MXNetError("kvstore must be a KVStore, a name or None, "
                             "got %s" % type(kvstore).__name__)
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._compression_params = compression_params
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False

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

    def _init_kvstore(self):
        """The JAX package's single-process ``_init_kvstore``: a KVStore
        object gets every initialized parameter's key and, unless
        ``update_on_kvstore=False``, the optimizer; no store otherwise."""
        kvstore = self._kvstore_type
        if isinstance(kvstore, kvs.KVStore):
            self._kvstore = kvstore
            if self._update_on_kvstore is None:
                self._update_on_kvstore = True
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            for i, param in enumerate(self._params):
                if param._data is not None:
                    kvstore.init(i, param.data())
            if self._update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        else:
            self._kvstore = None
            self._update_on_kvstore = False
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every parameter from its gradient, the gradients
        scaled by ``1 / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """Push the gradients to the kvstore (and, unless it updates,
        pull their sums back); nothing to do without one."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                self._kvstore.push(i, param.grad())
                if not self._update_on_kvstore:
                    self._kvstore.pull(i, param.grad())

    def update(self, batch_size, ignore_stale_grad=False):
        """``step`` without the gradient synchronisation."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() when parameters are updated on "
                             "kvstore is not supported. Try setting "
                             "`update_on_kvstore` to False.")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        if self._update_on_kvstore:
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    self._kvstore.pull(i, param.data())
            return
        if self._fused is None:
            self._fused = opt.FusedApplier.resolve(self._updaters[0])
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if live:
            self._fused([i for i, _ in live], [p.data() for _, p in live],
                        [p.grad() for _, p in live])

    def save_states(self, fname):
        """Write the optimizer's states, and the optimizer, to ``fname``
        (the store's when the store updates)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read a ``save_states`` file: the states, and the optimizer it
        holds, which becomes this Trainer's."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
            self._optimizer.param_dict = dict(enumerate(self._params))
            return
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read())
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._fused = None
