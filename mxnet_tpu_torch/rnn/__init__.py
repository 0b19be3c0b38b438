"""`mx.rnn`: the symbolic RNN API of the port (reference
`python/mxnet/rnn/`): cells, ``BucketSentenceIter`` and the checkpoint
helpers."""
from . import rnn_cell
from .rnn_cell import *
from .rnn import *
from .io import *
