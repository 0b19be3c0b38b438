"""`mx.sym.contrib` namespace (reference python/mxnet/symbol/contrib.py):
every registered ``_contrib_Foo`` op is exposed here as ``contrib.Foo``."""
from ..ops.registry import populate_prefixed
from .register import _make_fn

populate_prefixed(globals(), _make_fn, "_contrib_")
