"""Gluon layers of the port (reference `python/mxnet/gluon/nn/`)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
