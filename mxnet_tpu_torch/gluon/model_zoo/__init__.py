"""Gluon model zoo of the port (reference
`python/mxnet/gluon/model_zoo/`)."""
from . import vision

__all__ = ["vision"]
