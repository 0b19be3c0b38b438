"""`mx.nd` namespace of the port (reference `python/mxnet/ndarray/`):
the NDArray, its constructors, the ``.params`` format, one function per
registered op, ``nd.contrib`` and the samplers of ``nd.random``."""
from .. import ops as _ops  # noqa: F401  (registers the operators)
from .ndarray import NDArray, zeros, array
from .utils import save, load, load_frombuffer
from .register import populate as _populate

__all__ = ["NDArray", "zeros", "array", "save", "load",
           "load_frombuffer"]

_populate(globals())
from . import contrib  # noqa: E402,F401
from . import random  # noqa: E402,F401
