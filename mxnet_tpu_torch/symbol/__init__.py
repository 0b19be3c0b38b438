"""`mx.sym` namespace of the port (reference `python/mxnet/symbol/`)."""
from .. import ops as _ops  # noqa: F401  (registers the operators)
from .symbol import Symbol, var, Variable, Group, load_json, load, create
from .register import populate as _populate

_populate(globals())
from . import contrib  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
