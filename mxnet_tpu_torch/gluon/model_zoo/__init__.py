"""Gluon model zoo of the port (reference
`python/mxnet/gluon/model_zoo/`): the vision families and the local
weights store behind ``pretrained=True``."""
from . import model_store
from . import vision

__all__ = ["model_store", "vision"]
