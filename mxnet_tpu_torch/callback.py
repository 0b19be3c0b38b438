"""Training callbacks.

Counterpart of `mxnet_tpu/callback.py` (reference
`python/mxnet/callback.py`): the epoch-end checkpoints
``module_checkpoint`` and ``do_checkpoint``, the batch-end loggers
``log_train_metric``, ``Speedometer`` and ``ProgressBar``, and
``LogValidationMetricsCallback``. ``elastic_checkpoint`` waits for the
port's elastic training (ROADMAP A.10).

Every ``frequent`` batches ``Speedometer`` logs samples/s over the
batches since its last log, and the metric values. As in the JAX
package, the speed comes from the telemetry registry
(``fit_samples_total``, counted per batch by ``Module.fit``), so the
printed number and the exported metrics cannot disagree; outside an
instrumented fit loop (the counter not advancing) it falls back to the
reference's ``frequent * batch_size / elapsed``. Each log line also
publishes goodput and MFU (`xla_stats.goodput`: the ``mfu`` and
``model_flops_per_second`` gauges) once a train step's FLOPs are known,
and with ``MXNET_STEPPROF=1`` appends the step-anatomy shares of the
window and runprof's productive share.
"""
from __future__ import annotations

import logging
import math
import time

from . import runprof, stepprof, telemetry, xla_stats

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving ``mod``'s checkpoint every ``period``
    epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving the symbol and parameters it is handed
    every ``period`` epochs (`model.save_checkpoint`)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Throughput logger (reference callback.py Speedometer). The counter
    is process-wide: with several fit loops in one process each
    Speedometer reports the process's throughput over its window."""

    #: short display labels for the step-anatomy phase summary
    _PHASE_LABELS = (("data_wait", "data"), ("h2d", "h2d"),
                     ("dispatch", "disp"), ("device_compute", "compute"),
                     ("sync", "sync"), ("opt_update", "opt"),
                     ("other", "other"))

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset
        self._samples_tic = 0.0
        self._batches_tic = 0.0
        #: (epoch, batch, samples/s) of every log line, newest last
        self.history = []

    @staticmethod
    def _registry_samples():
        return telemetry.counter("fit_samples_total").value

    @staticmethod
    def _registry_batches():
        return telemetry.counter("fit_batches_total").value

    def _mark(self):
        self.tic = time.time()
        self._samples_tic = self._registry_samples()
        self._batches_tic = self._registry_batches()
        self._phase_tic = stepprof.totals()
        self._goodput_tic = runprof.state_seconds("train_productive")

    def _speed(self):
        elapsed = time.time() - self.tic
        done = self._registry_samples() - self._samples_tic
        if done > 0:
            return done / elapsed
        return self.frequent * self.batch_size / elapsed

    def _goodput_suffix(self):
        """" mfu: X% (Y model FLOP/s)" for the window since the last mark,
        or "" until a counted train step has published its FLOPs; also
        refreshes the ``model_flops_per_second`` / ``mfu`` gauges."""
        elapsed = time.time() - self.tic
        batches = self._registry_batches() - self._batches_tic
        g = xla_stats.goodput(batches, elapsed)
        if not g:
            return ""
        return "\tmfu: %.2f%% (%.3e model FLOP/s)" % (
            g["mfu"] * 100.0, g["model_flops_per_second"])

    def _phase_suffix(self):
        """One-line step-time anatomy for the window since the last mark,
        e.g. ``\\tdata 4% | compute 78% | sync 11%``; "" unless
        MXNET_STEPPROF is on and a phase advanced. Phases under 1% of the
        window are left out."""
        if not stepprof.enabled():
            return ""
        cur = stepprof.totals()
        prev = getattr(self, "_phase_tic", {})
        delta = {k: cur.get(k, 0.0) - prev.get(k, 0.0) for k in cur}
        total = sum(d for d in delta.values() if d > 0)
        if total <= 0:
            return ""
        parts = ["%s %.0f%%" % (label, 100.0 * delta.get(name, 0.0) / total)
                 for name, label in self._PHASE_LABELS
                 if delta.get(name, 0.0) / total >= 0.01]
        return "\t" + " | ".join(parts) if parts else ""

    def _runprof_suffix(self):
        """"\\tgoodput X%": runprof's productive share of the window since
        the last mark; "" unless MXNET_STEPPROF is on and productive
        seconds advanced."""
        if not stepprof.enabled():
            return ""
        elapsed = time.time() - self.tic
        done = runprof.state_seconds("train_productive") - \
            getattr(self, "_goodput_tic", 0.0)
        if elapsed <= 0 or done <= 0:
            return ""
        return "\tgoodput %.0f%%" % (min(1.0, done / elapsed) * 100.0)

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self._mark()
            return
        if count % self.frequent != 0:
            return
        speed = self._speed()
        self.history.append((param.epoch, count, speed))
        goodput = self._goodput_suffix()
        phases = self._phase_suffix() + self._runprof_suffix()
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += (goodput + phases).replace("%", "%%")
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s%s",
                         param.epoch, count, speed, goodput, phases)
        self._mark()


class ProgressBar:
    """Batch-end callback logging a bar of the epoch's progress."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Eval-end callback logging each validation metric."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
