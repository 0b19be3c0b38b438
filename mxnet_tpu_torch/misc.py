"""Deprecated learning-rate scheduler interface.

Counterpart of `mxnet_tpu/misc.py` (reference `python/mxnet/misc.py`, the
legacy API from before `lr_scheduler` that some old user code still
imports). New code should use `mxnet_tpu_torch.lr_scheduler`; this
module keeps the legacy call-on-iteration contract working: a scheduler
is CALLED with the iteration count and returns the lr, logging whenever
the returned rate changes.
"""
from __future__ import annotations

import logging

__all__ = ["LearningRateScheduler", "FactorScheduler"]


class LearningRateScheduler(object):
    """Legacy base: subclasses implement ``__call__(iteration) -> lr``;
    ``base_lr`` is assigned by the training loop after construction."""

    base_lr = 0.01

    def __call__(self, iteration):
        raise NotImplementedError("must override this")


class FactorScheduler(LearningRateScheduler):
    """lr = base_lr * factor^(iteration // step), logging on change."""

    def __init__(self, step, factor=0.1):
        if step < 1:
            raise ValueError(
                "Schedule step must be greater or equal than 1 round")
        if factor >= 1.0:
            raise ValueError("Factor must be less than 1 to make lr reduce")
        self.step = step
        self.factor = float(factor)
        self._last = None

    def __call__(self, iteration):
        # int(iteration / step), NOT floor division: the legacy contract
        # truncates toward zero and accepts non-integer steps
        lr = self.base_lr * self.factor ** int(iteration / self.step)
        if self._last is None:
            self._last = self.base_lr
        if lr != self._last:
            self._last = lr
            logging.info("At Iteration [%d]: Swith to new learning rate "
                         "%.5f", iteration, lr)
        return lr
