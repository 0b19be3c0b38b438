"""Datasets.

Counterpart of `mxnet_tpu/gluon/data/dataset.py` (reference
`python/mxnet/gluon/data/dataset.py`): ``Dataset`` with the lazy (or
eager) ``transform`` and ``transform_first``, ``SimpleDataset`` and
``ArrayDataset``. ``RecordFileDataset`` raises: the port has no RecordIO
reader yet.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """A dataset of ``fn(*sample)`` (``fn(sample)`` for a sample that
        is not a tuple), computed on access, or all at once with
        ``lazy=False``."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``transform`` of a sample's first element only."""
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    """A dataset over any sequence."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Samples drawn from arrays of one length, element ``i`` of each (a
    tuple for more than one array); a 1-D NDArray is read as numpy."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least 1 array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise MXNetError(
                    "All arrays must have the same length; array[0] has "
                    "length %d while array[%d] has %d."
                    % (self._length, i + 1, len(data)))
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """A dataset over a RecordIO file: not ported yet (the port has no
    ``recordio`` reader, ROADMAP.md, queue A item 11)."""

    def __init__(self, filename):
        raise MXNetError("RecordFileDataset(%s): the port has no RecordIO "
                         "reader yet" % filename)
