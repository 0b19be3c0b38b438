"""Gluon: the imperative neural-network front end of the port (reference
`python/mxnet/gluon/`): blocks, parameters, the layers ResNet uses and
the ResNet model zoo. ``Trainer``, losses, data loaders and the other
layers wait for the Gluon training slice."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock
from . import nn
from . import model_zoo

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "nn", "model_zoo"]
