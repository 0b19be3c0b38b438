"""Gluon: the imperative neural-network front end of the port (reference
`python/mxnet/gluon/`): blocks, parameters with gradient buffers and
``Constant``, the layers of ``nn``, the model zoo, ``Trainer``,
the losses, ``data`` (datasets, samplers, ``DataLoader``), ``utils``
(``split_and_load`` also at the top) and the recurrent layers and cells
of ``rnn``; ``contrib.nn`` (``Concurrent``, ``HybridConcurrent``,
``Identity``), and the model zoo's vision families."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo
from . import rnn
from . import contrib
from .utils import split_and_load

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock", "SymbolBlock",
           "Trainer",
           "nn", "loss", "data", "utils", "model_zoo", "rnn", "contrib",
           "split_and_load"]
