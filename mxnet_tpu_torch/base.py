"""Base types and dtype tables of the PyTorch port.

Counterpart of `mxnet_tpu/base.py`: the framework's error type and the
dtype tables that the ``.params`` format and the NDArray surface share.
Dtypes are kept two ways: numpy dtypes at the public surface (what
``NDArray.dtype`` returns, as in the JAX package) and ``torch.dtype``
inside, joined by one table.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "dtype_np", "torch_dtype", "numpy_dtype",
           "__version__"]

#: the MXNet API version the package follows, as the JAX package's
#: ``1.2.1+tpu0``, with the port's local tag
__version__ = "1.2.1+torch0"


class MXNetError(Exception):
    """Error raised by the framework (reference `python/mxnet/base.py`)."""


# mshadow type flags of the reference's binary format, by torch dtype.
# bfloat16 (12) is the JAX package's extension of the format.
_DTYPE_TORCH_TO_MX = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    torch.int8: 5,
    torch.int64: 6,
    torch.bool: 7,
    torch.bfloat16: 12,
}
_DTYPE_MX_TO_TORCH = {v: k for k, v in _DTYPE_TORCH_TO_MX.items()}

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def dtype_np(dtype):
    """Normalise a user-provided dtype (string/np.dtype/type) to np.dtype."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        return numpy_dtype(dtype)
    return np.dtype(dtype)


def torch_dtype(dtype):
    """Any dtype spelling (None = float32) -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[dtype_np(dtype)]
    except KeyError:
        raise MXNetError("unsupported dtype %s" % (dtype,)) from None


def numpy_dtype(dtype):
    """``torch.dtype`` -> np.dtype (bfloat16 has no numpy dtype)."""
    try:
        return _TORCH_TO_NP[dtype]
    except KeyError:
        raise MXNetError("dtype %s has no numpy counterpart" % dtype) from None
