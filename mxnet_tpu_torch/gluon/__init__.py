"""Gluon: the imperative neural-network front end of the port (reference
`python/mxnet/gluon/`): blocks, parameters with gradient buffers, the
layers ResNet uses, the ResNet model zoo, ``Trainer``, the losses,
``data`` (datasets, samplers, ``DataLoader``) and ``utils``. The other
layers, ``rnn`` and ``contrib`` are not ported yet."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "Trainer", "nn", "loss", "data", "utils",
           "model_zoo"]
