"""Gluon contrib data (counterpart of `mxnet_tpu/gluon/contrib/data.py`,
reference `python/mxnet/gluon/contrib/data/`): ``IntervalSampler`` and the
WikiText language-model datasets.

Nothing is downloaded: the WikiText classes read the standard
``wiki.{train,valid,test}.tokens`` file from ``root`` and raise when it
is absent. The windows are int32 NDArrays on the host.
"""
from __future__ import annotations

import io
import os

import numpy as np

from ..data import sampler as _sampler
from ..data.dataset import Dataset
from ... import ndarray as nd
from ...context import cpu
from ...contrib import text as _text

__all__ = ["IntervalSampler", "WikiText2", "WikiText103"]

EOS_TOKEN = "<eos>"


class IntervalSampler(_sampler.Sampler):
    """Samples [0, length) at fixed intervals
    (reference contrib/data/sampler.py:25)."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError("Interval %d must be <= length %d"
                             % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))


class _WikiText(Dataset):
    """Token-stream LM dataset cut into seq_len windows
    (reference contrib/data/text.py:59)."""

    _subdir = None

    def __init__(self, root, segment="train", seq_len=35):
        self._root = os.path.expanduser(root)
        self._segment = segment
        self._seq_len = seq_len
        self.vocabulary = None
        self._get_data()

    def _file_path(self):
        return os.path.join(self._root, "wiki.%s.tokens" % self._segment)

    def _get_data(self):
        path = self._file_path()
        if not os.path.exists(path):
            raise IOError(
                "%s not found, and nothing is downloaded: place the "
                "extracted %s files under %s." % (path, type(self).__name__,
                                                   self._root))
        with io.open(path, "r", encoding="utf8") as fin:
            content = fin.read()
        counter = _text.utils.count_tokens_from_str(content)
        counter.update([EOS_TOKEN])
        self.vocabulary = _text.vocab.Vocabulary(
            counter, unknown_token="<unk>", reserved_tokens=None)
        raw = [line.strip().split() for line in content.splitlines()]
        raw = [line + [EOS_TOKEN] for line in raw if line]
        ids = self.vocabulary.to_indices(
            [tok for line in raw for tok in line])
        data = np.asarray(ids[:-1], np.int32)
        label = np.asarray(ids[1:], np.int32)
        n = (len(data) // self._seq_len) * self._seq_len
        self._data = nd.array(data[:n].reshape(-1, self._seq_len),
                              ctx=cpu(), dtype="int32")
        self._label = nd.array(label[:n].reshape(-1, self._seq_len),
                               ctx=cpu(), dtype="int32")

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)


class WikiText2(_WikiText):
    """WikiText-2 (reference contrib/data/text.py:106)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-2"),
                 segment="train", seq_len=35):
        super().__init__(root, segment, seq_len)


class WikiText103(_WikiText):
    """WikiText-103 (reference contrib/data/text.py:144)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-103"),
                 segment="train", seq_len=35):
        super().__init__(root, segment, seq_len)
