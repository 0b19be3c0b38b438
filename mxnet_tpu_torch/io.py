"""Data iterators.

Counterpart of `mxnet_tpu/io.py` (reference `python/mxnet/io.py` and the
C++ iterators of `src/io/`): ``DataDesc``, ``DataBatch``, the
``DataIter`` protocol, ``NDArrayIter`` (shuffle with numpy's global
generator, and ``last_batch_handle`` ``pad``, ``discard`` or
``roll_over``), ``ResizeIter``, ``PrefetchingIter`` (a producer thread
and a bounded queue, with the JAX package's telemetry series) and the
file iterators ``MNISTIter`` (idx files, gzipped or not), ``CSVIter`` and
``LibSVMIter`` (dense batches, as in the JAX package). Batches are
NDArrays on the current context (`context.current_context`, the CPU by
default, and always the CPU on a prefetching thread, whose scope is its
own); ``Module`` copies them onto its own device. The record iterators
(``ImageRecordIter``, ``ImageDetRecordIter``) wait for ROADMAP A.11.
"""
from __future__ import annotations

import gzip
import os
import queue as _queue
import struct
import threading
import time
import weakref
from collections import namedtuple

import numpy as np

from . import telemetry, threadsan
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        """The axis of ``N`` in ``layout`` (0 when there is no layout)."""
        if layout is None:
            return 0
        return layout.find("N")


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

    def hard_reset(self):
        """``reset`` that also drops a ``roll_over`` epoch's cached tail,
        so the next epoch starts from the first sample."""
        if self.shuffle:
            np.random.shuffle(self.idx)
        self._cache_data = None
        self._cache_label = None
        self.cursor = -self.batch_size

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


class ResizeIter(DataIter):
    """Another iterator cut or repeated to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _put(queue, item, stop, wait):
    """Put ``item`` unless ``stop`` is set, re-checking it every 50 ms;
    the time blocked goes to ``wait``. Returns False on stop."""
    t0 = time.monotonic()
    try:
        while not stop.is_set():
            try:
                queue.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False
    finally:
        wait.observe(time.monotonic() - t0)


def _produce(it, queue, stop, error, wait):
    """The producer thread: the wrapped iterator's batches, then None. It
    holds no reference to the PrefetchingIter, so a dropped one is
    collected and its ``__del__`` stops this thread. An exception of the
    wrapped iterator goes to ``error`` (a one-slot list under its lock)
    and is raised on the consumer's side."""
    try:
        for batch in it:
            if not _put(queue, batch, stop, wait):
                return
    except Exception as exc:   # noqa: BLE001 - raised by the consumer
        with error[0]:
            error[1] = exc
    finally:
        _put(queue, None, stop, wait)


class PrefetchingIter(DataIter):
    """The wrapped iterator's batches made ahead by a background thread
    (reference iter_prefetcher.h, io.py PrefetchingIter), at most
    ``depth`` waiting.

    Telemetry, under the JAX package's names: the ``prefetch_queue_depth``
    gauge (the ready batches, sampled at scrape; the last iterator made
    reports) and the ``prefetch_wait_seconds{side=}`` histograms:
    ``consumer`` is the time the training loop waited for a batch (the
    input is the bottleneck), ``producer`` the time the thread waited on
    a full queue."""

    def __init__(self, iters, rename_data=None, rename_label=None, depth=2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter == 1, "PrefetchingIter wraps one iterator"
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = iters[0].batch_size
        self._depth = depth
        self._queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = None
        # the only state the queue does not order: the producer's error
        self._error = [threadsan.register("io.PrefetchingIter._err_lock",
                                          threading.Lock()), None]
        self.current_batch = None
        self._wait_producer = telemetry.histogram(
            "prefetch_wait_seconds",
            help="prefetch waits: consumer=training loop starved, "
                 "producer=queue full (healthy)", side="producer")
        self._wait_consumer = telemetry.histogram(
            "prefetch_wait_seconds", side="consumer")
        ref = weakref.ref(self)

        def _depth_now():
            it = ref()
            return None if it is None else it._queue.qsize()
        telemetry.gauge(
            "prefetch_queue_depth",
            help="ready batches in the prefetch queue (sampled at "
                 "scrape; last-constructed PrefetchingIter reports)"
        ).set_function(_depth_now)
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return self.iters[0].provide_data
        return [DataDesc(self.rename_data[0].get(d.name, d.name), d.shape,
                         d.dtype) for d in self.iters[0].provide_data]

    @property
    def provide_label(self):
        if self.rename_label is None:
            return self.iters[0].provide_label
        return [DataDesc(self.rename_label[0].get(d.name, d.name), d.shape,
                         d.dtype) for d in self.iters[0].provide_label]

    def _start(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=_produce, args=(self.iters[0], self._queue, self._stop,
                                   self._error, self._wait_producer),
            daemon=True)
        self._thread.start()

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()

    def reset(self):
        """Stop the producer (draining the queue until it exits, within
        ``MXNET_PREFETCH_JOIN_TIMEOUT`` seconds, 30 by default), reset the
        wrapped iterator and start a new producer."""
        self._stop.set()
        try:
            budget = float(os.environ.get("MXNET_PREFETCH_JOIN_TIMEOUT",
                                          "30"))
        except ValueError:
            import warnings
            warnings.warn("bad MXNET_PREFETCH_JOIN_TIMEOUT=%r ignored"
                          % os.environ["MXNET_PREFETCH_JOIN_TIMEOUT"])
            budget = 30.0
        deadline = time.monotonic() + budget
        while self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "PrefetchingIter.reset: producer thread did not "
                    "exit within %gs (MXNET_PREFETCH_JOIN_TIMEOUT); "
                    "the wrapped iterator is wedged" % budget)
        with self._error[0]:
            self._error[1] = None
        self.iters[0].reset()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._start()

    def iter_next(self):
        t0 = time.monotonic()
        batch = self._queue.get()
        self._wait_consumer.observe(time.monotonic() - t0)
        if batch is None:
            with self._error[0]:
                err, self._error[1] = self._error[1], None
            if err is not None:
                raise err
            return False
        self.current_batch = batch
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _read_idx(path):
    """An idx file (``path`` or ``path.gz``) as a uint8 array."""
    opener = gzip.open if path.endswith(".gz") else open
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path, opener = path + ".gz", gzip.open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class MNISTIter(NDArrayIter):
    """Reference `src/io/iter_mnist.cc`: images and labels from idx files
    (optionally gzipped), the images scaled to [0, 1]."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, data_name="data",
                 label_name="softmax_label", **kwargs):
        img = _read_idx(image).astype(np.float32) / 255.0
        lbl = _read_idx(label)
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        super().__init__(img, lbl.astype(np.float32), batch_size=batch_size,
                         shuffle=bool(shuffle), data_name=data_name,
                         label_name=label_name)


class CSVIter(NDArrayIter):
    """Reference `src/io/iter_csv.cc`: rows of a CSV file reshaped to
    ``data_shape``; labels from ``label_csv`` or zeros."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard",
                         **{k: v for k, v in kwargs.items()
                            if k in ("shuffle", "data_name", "label_name")})


class LibSVMIter(DataIter):
    """Reference `src/io/iter_libsvm.cc`: the libsvm text format
    (``label index:value ...``), read into dense batches as the JAX
    package does."""

    def __init__(self, data_libsvm, data_shape, label_shape=None,
                 batch_size=1, **kwargs):
        super().__init__(batch_size)
        dim = int(np.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(dim, dtype=np.float32)
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        self._inner = NDArrayIter(np.stack(rows),
                                  np.asarray(labels, np.float32),
                                  batch_size=batch_size,
                                  **{k: v for k, v in kwargs.items()
                                     if k in ("shuffle",)})

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()
