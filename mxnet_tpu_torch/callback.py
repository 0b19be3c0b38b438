"""Training callbacks.

Counterpart of `mxnet_tpu/callback.py` (reference
`python/mxnet/callback.py`), cut to ``Speedometer``: every ``frequent``
batches it logs samples/s over the batches since its last log, and the
metric values. The JAX package reads its speed from the telemetry
registry and appends step-anatomy shares; those layers are not ported
yet, so the speed here is the reference's ``frequent * batch_size /
elapsed``.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer"]


class Speedometer:
    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset
        #: (epoch, batch, samples/s) of every log line, newest last
        self.history = []

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        self.history.append((param.epoch, count, speed))
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()
