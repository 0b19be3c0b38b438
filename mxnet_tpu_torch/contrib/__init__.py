"""Contrib front-end modules of the port (counterpart of
`mxnet_tpu/contrib/__init__.py`, reference `python/mxnet/contrib/`):
``nd``/``ndarray`` and ``sym``/``symbol`` (the ``_contrib_`` ops),
``autograd`` (the legacy imperative API) and ``text`` (vocabularies and
token embeddings). ``io``, ``quantization`` and ``tensorboard`` wait for
ROADMAP A.11; ``onnx`` is not queued (no ``onnx`` package)."""
from ..ndarray import contrib as ndarray
from ..ndarray import contrib as nd
from ..symbol import contrib as symbol
from ..symbol import contrib as sym
from . import autograd
from . import text

__all__ = ["ndarray", "nd", "symbol", "sym", "autograd", "text"]
