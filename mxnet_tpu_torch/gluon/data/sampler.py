"""Samplers.

Counterpart of `mxnet_tpu/gluon/data/sampler.py` (reference
`python/mxnet/gluon/data/sampler.py`): ``SequentialSampler``,
``RandomSampler`` (a permutation from numpy's global generator, so
``np.random.seed`` fixes it) and ``BatchSampler``, whose last short
batch is kept, discarded or rolled over into the next epoch.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_LAST_BATCH = ("keep", "discard", "rollover")


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        np.random.shuffle(indices)
        return iter(indices)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler``."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST_BATCH:
            raise ValueError("last_batch must be one of 'keep', 'discard', "
                             "or 'rollover', but got %s" % last_batch)
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._prev) + len(self._sampler)) // self._batch_size
