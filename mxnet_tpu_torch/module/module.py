"""Module: symbolic training on one executor.

Counterpart of `mxnet_tpu/module/module.py` (reference
`python/mxnet/module/module.py`), on one device: ``bind`` (with a
``type_dict``, e.g. bf16 data and parameters), ``init_params``,
``set_params``/``get_params`` (arguments and auxiliary states),
``init_optimizer``, ``forward``, ``backward``, ``forward_backward``,
``update``, ``_step``, ``_step_scan``, ``get_outputs``, ``update_metric``
and checkpoints, with the optimizer's states when asked
(``save_optimizer_states``, ``prefix-%04d.states``). ``update`` applies
the optimizer to every parameter in one call of
``optimizer.FusedApplier``. The auxiliary states (BatchNorm's moving
statistics) live in the executor and are updated in place by every
training forward, so ``_step`` and ``_step_scan`` carry them from step to
step.

The context defaults to ``gpu(0)`` (the JAX package's to ``cpu()``), and
a module on a GPU context without that CUDA device raises at
construction. Batches may live anywhere: ``forward`` copies them onto the
module's device. The JAX package fuses a train step into one compiled
program and ``_step_scan`` runs K of them in one ``lax.scan`` dispatch;
here both run eagerly (K steps in a Python loop, their batches staged on
the device up front as the JAX package stages them) with the same
semantics. With a ``KVStore`` object (`kvstore.py`) the module updates on
the store, as the reference does: ``init_optimizer`` initializes every
parameter's key and sets the optimizer there, and ``update`` pushes the
gradients as one list and pulls the weights back. Multi-device contexts,
the distributed kvstores, SPMD sharding, ``group2ctxs``, bucketing and the monitor wait for
later slices.
"""
from __future__ import annotations

import logging
import warnings

import torch

from .. import kvstore as kvs
from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, gpu
from ..executor import Executor
from ..initializer import InitDesc, Uniform
from ..io import DataBatch
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule, _check_input_names


def _create_kvstore(kvstore, num_device):
    """Reference `python/mxnet/model.py:_create_kvstore`, for one device:
    (kvstore, update_on_kvstore). A KVStore object is used as it is and
    updates on the store; None, or a single-process name on one device,
    means no kvstore; a ``dist*`` name raises (ROADMAP A.10)."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, kvs.KVStore):
        return kvstore, True
    if isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            return None, False
        kvs.create(kvstore)         # raises: distributed, not ported yet
    raise TypeError("kvstore must be KVStore, str or None")


def _norm_shapes(shapes):
    return [(s[0], tuple(s[1])) for s in shapes]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = gpu(0)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module runs on one device; got %d contexts"
                                 % len(context))
            context = context[0]
        if not isinstance(context, Context):
            raise MXNetError("context must be a Context")
        context.torch_device()      # no such CUDA device: raise here
        self._context = context
        self._symbol = symbol
        data_names = list(data_names or [])
        label_names = list(label_names or [])
        state_names = list(state_names or [])
        fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._fused = None
        self._preload_opt_states = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from ``prefix-symbol.json`` and ``prefix-%04d.params``;
        with ``load_optimizer_states``, ``init_optimizer`` then reads
        ``prefix-%04d.states``."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write the symbol and parameters, and with
        ``save_optimizer_states`` the updater's states to
        ``prefix-%04d.states``."""
        from ..model import save_checkpoint
        save_checkpoint(prefix, epoch, self.symbol, *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- properties ------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return list(zip(self._output_names, self._out_shapes))

    # -- params ----------------------------------------------------------
    def _check_ready(self, optimizer=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind the module and initialize its parameters "
                             "first")
        if optimizer and not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")

    def get_params(self):
        """({name: NDArray}, {name: NDArray}): the module's own parameter
        and auxiliary-state arrays."""
        self._check_ready()
        self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the parameters: from ``arg_params`` (NDArrays or numpy
        arrays, e.g. a JAX module's ``get_params()`` read back with
        ``asnumpy``) where given, else by ``initializer``, in
        ``list_arguments`` order as the JAX package does; then the
        auxiliary states from ``aux_params``, else by ``initializer``
        (moving means zero, moving variances one)."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. init_params call ignored.",
                          stacklevel=2)
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                src = cache[name]
                if src is not arr:
                    if tuple(src.shape) != arr.shape:
                        raise MXNetError("shape mismatch for %s: %s vs %s"
                                         % (name, tuple(src.shape),
                                            arr.shape))
                    arr[:] = src
            elif cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs={}), arr)

        attrs = self._symbol.attr_dict()
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            desc_attrs = attrs.get(name, {})
            if initializer is not None and "__init__" in desc_attrs and \
                    (arg_params is None or name not in arg_params):
                initializer(InitDesc(name, attrs=desc_attrs), arr)
            else:
                _impl(name, arr, arg_params)
        for name in self._aux_names:
            _impl(name, self._exec.aux_dict[name], aux_params)
        self.params_initialized = True
        self._sync_params_from_devices()

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Copy ``{name: NDArray or numpy}`` into the parameters."""
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. set_params call ignored.",
                          stacklevel=2)
            return
        for src, dst in ((arg_params, self._exec.arg_dict),
                         (aux_params, self._exec.aux_dict)):
            for name, arr in (src or {}).items():
                if name in dst:
                    dst[name][:] = arr
        self.params_initialized = True

    def _sync_params_from_devices(self):
        if self.binded:
            self._arg_params = {n: self._exec.arg_dict[n]
                                for n in self._param_names}
            self._aux_params = {n: self._exec.aux_dict[n]
                                for n in self._aux_names}

    # -- bind ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", type_dict=None):
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes or [])
        shapes = dict(self._data_shapes + self._label_shapes)
        data_names = [d[0] for d in self._data_shapes]
        req = {}
        for name in self._symbol.list_arguments():
            if not for_training:
                req[name] = "null"
            elif name in self._param_names:
                req[name] = "null" if name in self._fixed_param_names \
                    else grad_req
            elif name in data_names:
                req[name] = grad_req if inputs_need_grad else "null"
            else:
                req[name] = "null"
        self._grad_req = req
        shared_exec = shared_module._exec if shared_module is not None \
            else None
        self._exec = Executor.simple_bind(self._symbol, self._context,
                                          grad_req=req, type_dict=type_dict,
                                          shared_exec=shared_exec, **shapes)
        from ..symbol.symbol import _graph_infer
        _, self._out_shapes = _graph_infer(self._symbol, shapes,
                                           type_dict=type_dict)
        self.binded = True
        # restore parameters held before the bind (e.g. after Module.load)
        for held, dsts in ((self._arg_params, self._exec.arg_dict),
                           (self._aux_params, self._exec.aux_dict)):
            for name, arr in (held or {}).items():
                dst = dsts.get(name)
                if dst is not None and dst is not arr:
                    dst[:] = arr
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
            self._sync_params_from_devices()

    def reshape(self, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("bind the module first")
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes or [])
        self._exec = self._exec.reshape(
            **dict(self._data_shapes + self._label_shapes))

    # -- optimizer -------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._check_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kvstore, update_on_kvstore = _create_kvstore(kvstore, 1)
        # data is batch-major for most graphs; the word LM's is (T, B),
        # and the reference takes dim 0 all the same
        rescale_grad = 1.0 / self._data_shapes[0][1][0]
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            if not isinstance(optimizer, opt.Optimizer):
                raise MXNetError("optimizer must be a name or an Optimizer")
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn("Optimizer created manually outside Module but "
                              "rescale_grad is not normalized to "
                              "1.0/batch_size. Is this intended?",
                              stacklevel=2)
            if not optimizer.idx2name:
                optimizer.param_dict = {}
                optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        self._fused = None
        if kvstore:
            for i, name in enumerate(self._param_names):
                kvstore.init(i, self._exec.arg_dict[name])
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def save_optimizer_states(self, fname):
        """Write the updater's states (numpy arrays, pickled) to
        ``fname``, in the JAX package's format (the store's updater when
        updating on a kvstore)."""
        self._check_ready(optimizer=True)
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Read a ``save_optimizer_states`` file into the updater."""
        self._check_ready(optimizer=True)
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # -- compute ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._check_ready()
        if is_train is None:
            is_train = self.for_training
        self._load_batch(data_batch)
        self._exec.forward(is_train=is_train)

    def _load_batch(self, data_batch):
        """Copy the batch into the bound inputs, on the module's device;
        a batch of another shape rebinds (reference dynamic batch)."""
        data = data_batch.data
        labels = data_batch.label or []
        if any(self._exec.arg_dict[n].shape != tuple(a.shape)
               for n, a in zip(self._data_names, data)):
            self.reshape([(n, a.shape) for n, a in
                          zip(self._data_names, data)],
                         [(n, a.shape) for n, a in
                          zip(self._label_names, labels)] or None)
        for name, arr in zip(self._data_names, data):
            self._exec.arg_dict[name][:] = arr
        for name, arr in zip(self._label_names, labels):
            if name in self._exec.arg_dict:
                self._exec.arg_dict[name][:] = arr

    def backward(self, out_grads=None):
        self._check_ready()
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to every parameter that has a gradient: on
        the kvstore (a list push of the gradients, a list pull of the
        weights), or in one call of ``optimizer.FusedApplier``, after a
        push and pull of the gradients where a kvstore reduces them
        (reference module.py ``update`` and model.py
        ``_update_params``)."""
        self._check_ready(optimizer=True)
        live = [(i, name) for i, name in enumerate(self._param_names)
                if self._grad_req.get(name, "null") != "null"
                and self._exec.grad_dict.get(name) is not None]
        if not live:
            return
        idx = [i for i, _ in live]
        grads = [self._exec.grad_dict[n] for _, n in live]
        if self._update_on_kvstore:
            self._kvstore.push(idx, grads)
            self._kvstore.pull(idx, [self._exec.arg_dict[n]
                                     for _, n in live])
            return
        if self._kvstore:
            self._kvstore.push(idx, grads)
            self._kvstore.pull(idx, grads)
        if self._fused is None:
            self._fused = opt.FusedApplier.resolve(self._updater)
        self._fused(idx, [self._exec.arg_dict[n] for _, n in live], grads)

    def _step_scan(self, data_batches):
        """``len(data_batches)`` train steps, one after the other. Returns
        the per-step outputs stacked (a list over the module's outputs,
        each with a leading axis K) for the metrics, as the JAX package's
        one-dispatch ``lax.scan`` form does; ``False`` when the inputs
        need gradients (the caller then steps batch by batch)."""
        if len(data_batches) == 1:
            self._step(data_batches[0])
            return None
        if self.inputs_need_grad:
            return False
        per_step = []
        for batch in self.stack_batches(data_batches):
            self._step(batch)
            per_step.append([o.data for o in self._exec.outputs])
        return [NDArray(torch.stack(outs), self._context)
                for outs in zip(*per_step)]

    def stack_batches(self, data_batches):
        """Stage K batches on the module's device up front, one stacked
        (K, ...) copy per input (the JAX package's ``stack_batches``), and
        return them as K batches of views. A batch copied from pageable
        host memory waits for the device to finish the work queued before
        it; staged, the K steps queue without waiting."""
        dev = self._context.torch_device()

        def stack(arrays):
            return torch.stack([a.data for a in arrays]).to(dev)

        data = [stack([b.data[i] for b in data_batches])
                for i in range(len(self._data_names))]
        labels = [stack([b.label[i] for b in data_batches])
                  for i in range(len(data_batches[0].label or []))]
        return [DataBatch(data=[NDArray(d[k], self._context) for d in data],
                          label=[NDArray(lb[k], self._context)
                                 for lb in labels])
                for k in range(len(data_batches))]

    def get_outputs(self, merge_multi_context=True):
        self._check_ready()
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        self._check_ready()
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update_dict(dict(zip(self._label_names, labels or [])),
                                dict(zip(self._output_names,
                                         self._exec.outputs)))
