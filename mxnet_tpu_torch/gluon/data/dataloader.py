"""DataLoader.

Counterpart of `mxnet_tpu/gluon/data/dataloader.py` (reference
`python/mxnet/gluon/data/dataloader.py`): batches of a dataset's samples
by a ``BatchSampler``, stacked by ``default_batchify_fn`` (NDArrays
stacked on their context, tuples element by element, anything else
through numpy into ``nd.array`` on the current context). With
``num_workers`` > 0, as in the JAX package, that many threads gather and
batchify the batches and the loader yields them in order.
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np
import torch

from ...ndarray.ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d.data for d in data]), data[0].context)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return array(data, dtype=data.dtype)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._batch(batch)
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        """Workers take batches from a job queue and hand them back
        through a result queue; this thread puts them in order."""
        batches = list(self._batch_sampler)
        jobs = _queue.Queue()
        for i, b in enumerate(batches):
            jobs.put((i, b))
        done = _queue.Queue()

        def worker():
            while True:
                try:
                    i, b = jobs.get_nowait()
                except _queue.Empty:
                    return
                done.put((i, self._batch(b)))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        results, nxt = {}, 0
        for _ in batches:
            i, batch = done.get()
            results[i] = batch
            while nxt in results:
                yield results.pop(nxt)
                nxt += 1
        for t in threads:
            t.join()

    def __len__(self):
        return len(self._batch_sampler)
