"""`mx.sym.linalg` namespace (reference python/mxnet/symbol/linalg.py):
every registered ``_linalg_*`` op by its short name."""
from ..ops.registry import populate_prefixed
from .register import _make_fn

__all__ = populate_prefixed(globals(), _make_fn, "_linalg_")
