"""Gluon contrib of the port (reference `python/mxnet/gluon/contrib/`):
``nn`` so far; the JAX package's ``contrib.rnn`` and ``contrib.data``
wait for the next slice (ROADMAP A.3)."""
from . import nn

__all__ = ["nn"]
