"""Data iterators.

Counterpart of `mxnet_tpu/io.py` (reference `python/mxnet/io.py`), cut to
the in-memory path: ``DataDesc``, ``DataBatch``, the ``DataIter``
protocol and ``NDArrayIter`` (shuffle with numpy's global generator, and
``last_batch_handle`` ``pad``, ``discard`` or ``roll_over``). Batches are
NDArrays on the current context (`context.current_context`, the CPU by
default); ``Module`` copies them onto its own device. The file, record
and prefetching iterators wait for a later slice.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("Data must be list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError("Label must be list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        label_shapes = [lb.shape for lb in self.label] if self.label \
            else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, [d.shape for d in self.data],
            label_shapes)


class DataIter:
    """Reference DataIter protocol: reset/next/iter + provide_data."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class NDArrayIter(DataIter):
    """Reference io.py NDArrayIter: dict/list/NDArray data, shuffle,
    pad/discard/roll_over last-batch handling."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self.num_data = self.idx.shape[0]
        self._cache_data = None
        self._cache_label = None
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self._cache_data is not None:
            # the previous epoch's tail leads the new one: shift the
            # cursor so the first batch takes batch_size - k new samples
            k = self._cache_data[0].shape[0]
            self.cursor = -self.batch_size - k
        else:
            self._cache_data = None
            self._cache_label = None
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if self.cursor >= 0:
            # the roll-over cache is only consumed by the epoch's first batch
            self._cache_data = None
            self._cache_label = None
        if self.last_batch_handle == "roll_over" and \
                data and data[0].shape[0] < self.batch_size:
            # incomplete tail: hold it for the next epoch
            self._cache_data = data
            self._cache_label = label
            raise StopIteration
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def _getdata(self, data_source, cache=None):
        end = min(self.cursor + self.batch_size, self.num_data)
        s = slice(max(self.cursor, 0), end)
        out = []
        for i, (_, arr) in enumerate(data_source):
            sel = arr[self.idx[s]]
            if cache is not None and self.cursor < 0:
                sel = np.concatenate([cache[i].asnumpy(), sel], axis=0)
            if sel.shape[0] < self.batch_size and \
                    self.last_batch_handle == "pad":
                need = self.batch_size - sel.shape[0]
                sel = np.concatenate([sel, arr[self.idx[:need]]], axis=0)
            out.append(array(sel, dtype=sel.dtype))
        return out

    def getdata(self):
        return self._getdata(self.data, self._cache_data)

    def getlabel(self):
        return self._getdata(self.label, self._cache_label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise ValueError("NDArrayIter needs data")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("NDArrayIter needs data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]
