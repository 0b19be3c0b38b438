"""Gluon contrib of the port (counterpart of
`mxnet_tpu/gluon/contrib/__init__.py`, reference
`python/mxnet/gluon/contrib/`): ``nn``, ``rnn`` (the conv cells,
``VariationalDropoutCell``, ``LSTMPCell``) and ``data``
(``IntervalSampler``, WikiText from local files)."""
from . import nn
from . import rnn
from . import data

__all__ = ["nn", "rnn", "data"]
