"""`gluon.rnn`: recurrent layers and cells of the port (reference
`python/mxnet/gluon/rnn/`)."""
from .rnn_cell import *
from .rnn_layer import *
