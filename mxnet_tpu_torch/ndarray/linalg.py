"""`mx.nd.linalg` namespace (reference python/mxnet/ndarray/linalg.py):
every registered ``_linalg_*`` op by its short name (gemm, gemm2, potrf,
potri, trsm, trmm, sumlogdiag, syrk, gelqf, syevd, inverse, det)."""
from ..ops.registry import populate_prefixed
from .register import _make_fn

__all__ = populate_prefixed(globals(), _make_fn, "_linalg_")
