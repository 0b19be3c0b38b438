"""BaseModule: the training-loop contract.

Counterpart of `mxnet_tpu/module/base_module.py` (reference
`python/mxnet/module/base_module.py`): ``forward_backward``, ``_step``,
``score``, ``iter_predict``, ``predict``, ``fit`` and its loop, cut to what
a one-device run without a kvstore needs. The loop is the reference's: per
batch a train step, then ``update_metric``, then the batch callbacks; at
the end of an epoch the epoch callbacks and ``score`` on the eval data.
``fit(..., batches_per_dispatch=K)`` hands K batches at a time to
``_step_scan``; ``fit(..., monitor=)`` installs a `monitor.Monitor` and
brackets each batch with its ``tic`` and ``toc_print`` (and then steps
batch by batch, as the JAX package does).

The loop carries the JAX package's observability: each iteration is one
stepprof step (``data_wait`` while the iterator blocks, the step's own
phases, ``device_compute`` while the metric reads the outputs back);
each batch counts into ``fit_batches_total`` / ``fit_samples_total``
(which `callback.Speedometer` reads) and every
``MXNET_RUNPROF_CHECK_EVERY``-th one sweeps the metric values through
runprof's health sentinels; an exception out of the loop dumps the
flight recorder before it propagates. Elastic checkpoints are
distributed training (ROADMAP A.10).
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from .. import runprof, stepprof, telemetry, xla_stats


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _count_fit_batch(batch, eval_metric=None):
    """Per-batch throughput series (`callback.Speedometer` reads its
    samples/s from them), and every ``MXNET_RUNPROF_CHECK_EVERY``-th
    batch the metric values through runprof's health sentinels: a NaN or
    Inf loss trips ``run_anomalies_total`` and a flight-recorder dump."""
    samples = int(batch.data[0].shape[0]) if batch.data else 0
    telemetry.counter("fit_batches_total",
                      help="train batches completed by Module.fit").inc()
    if samples:
        telemetry.counter("fit_samples_total",
                          help="train samples completed by Module.fit"
                          ).inc(samples)
    if eval_metric is not None and runprof.should_check():
        runprof.observe_metrics(eval_metric.get_name_value())


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args
                      if not arg.endswith(("_weight", "_bias", "_gamma",
                                           "_beta"))]
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). Did "
               "you mean one of:\n\t%s" % (typename, names, name,
                                           "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high level API --------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _step(self, data_batch):
        """One training step of the fit loop."""
        self.forward_backward(data_batch)
        self.update()

    def install_monitor(self, mon):
        raise NotImplementedError("%s has no monitor" % type(self).__name__)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("score needs a bound, initialized module")
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for callback in _as_list(batch_end_callback):
                callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals()))
            actual_num_batch += 1
        for callback in _as_list(score_end_callback):
            callback(BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs without the batch's pad, batch index, batch)
        for each batch of ``eval_data``."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("iter_predict needs a bound, initialized "
                               "module")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            yield ([out[0:out.shape[0] - pad]
                    for out in self.get_outputs()], nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` (a DataIter, or one array taken
        as a single batch), the pad of each batch cut off; merged along
        the batch axis with ``merge_batches``, one array when the module
        has one output unless ``always_output_list``."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("predict needs a bound, initialized module")
        from .. import io as io_mod
        from ..ndarray import NDArray, concatenate
        if isinstance(eval_data, (NDArray, np.ndarray)):
            eval_data = io_mod.NDArrayIter(eval_data,
                                           batch_size=eval_data.shape[0])
        output_list = [[out.copy() for out in outputs] for outputs, _, _
                       in self.iter_predict(eval_data, num_batch, reset)]
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        if any(len(out) != num_outputs for out in output_list):
            raise ValueError("Cannot merge batches, as num of outputs is not "
                             "the same in mini-batches. Maybe bucketing is "
                             "used?")
        merged = [concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, batches_per_dispatch=1):
        """Reference base_module.py:395 training loop."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = metric_mod.create(eval_metric)
        if monitor is not None:
            batches_per_dispatch = 1
        try:
            self._fit_loop(train_data, eval_data, eval_metric,
                           validation_metric, epoch_end_callback,
                           batch_end_callback, eval_end_callback,
                           eval_batch_end_callback, monitor,
                           batches_per_dispatch, begin_epoch, num_epoch)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:
            # the crash flight recorder: the last telemetry events and the
            # compile/step metadata on disk before the traceback unwinds
            xla_stats.dump_flight_recorder(
                "fit_exception",
                error="%s: %s" % (type(exc).__name__, str(exc)[:400]))
            raise

    def _fit_loop(self, train_data, eval_data, eval_metric,
                  validation_metric, epoch_end_callback, batch_end_callback,
                  eval_end_callback, eval_batch_end_callback, monitor,
                  batches_per_dispatch, begin_epoch, num_epoch):
        """The epochs of :meth:`fit`."""
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            self._fit_epoch(train_data, eval_metric, epoch,
                            batch_end_callback, batches_per_dispatch,
                            monitor)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            for callback in _as_list(epoch_end_callback):
                callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def _fit_epoch(self, train_data, eval_metric, epoch, batch_end_callback,
                   batches_per_dispatch, monitor=None):
        """One epoch of :meth:`fit`: groups of up to ``batches_per_dispatch``
        batches of one shape, each group one ``_step_scan`` (or ``_step``
        per batch when the module cannot scan) and one stepprof step, then
        the metric and the batch callbacks per batch."""
        eval_metric.reset()
        nbatch = 0
        data_iter = iter(train_data)
        pending = next(data_iter, None)
        while pending is not None:
            group = [pending]
            with stepprof.step() as sp:
                with stepprof.phase("data_wait") as wait:
                    pending = next(data_iter, None)
                    while pending is not None \
                            and len(group) < batches_per_dispatch \
                            and pending.data[0].shape == \
                            group[0].data[0].shape:
                        group.append(pending)
                        pending = next(data_iter, None)
                    if pending is None:
                        wait["end_of_epoch"] = True
                sp["batches"] = len(group)
                stacked = self._step_scan(group) if len(group) > 1 \
                    else False
                for k, batch in enumerate(group):
                    if stacked is False:
                        if monitor is not None:
                            monitor.tic()
                            self.forward_backward(batch)
                            self.update()
                        else:
                            self._step(batch)
                    with stepprof.phase("device_compute",
                                        via="update_metric"):
                        if stacked:
                            eval_metric.update_dict(
                                dict(zip(self.label_names,
                                         batch.label or [])),
                                {name: out[k] for name, out in
                                 zip(self.output_names, stacked)})
                        else:
                            self.update_metric(eval_metric, batch.label)
                    _count_fit_batch(batch, eval_metric)
                    if monitor is not None:
                        monitor.toc_print()
                    for callback in _as_list(batch_end_callback):
                        callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=locals()))
                    nbatch += 1

    # -- symbol/params ---------------------------------------------------
    @property
    def symbol(self):
        return self._symbol
