"""Carrying weights between the JAX package and the port.

Parameter names and layouts are the same in both packages (the RNN op's
flat vector is the cuDNN layout in both), so moving a model across is a
typed copy onto a device. ``params_to_numpy`` reads either package's
``{name: NDArray}`` (a ``Module.get_params()`` half, say) back to the
host; ``params_from_numpy`` puts such a dict on a device of the port, and
the port's ``Module.set_params`` / ``init_params(arg_params=...)`` also
take the numpy dict as it is. Both packages read and write the same
``.params`` container (`ndarray/utils.py`), which is the other way
across.
"""
from __future__ import annotations

import numpy as np

from .context import Context
from .ndarray.ndarray import array

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(arrays, device: Context):
    """``{name: np.ndarray}`` -> ``{name: NDArray}`` on ``device``,
    keeping each array's dtype (the form `Predictor` and
    `InferenceEngine` take as ``param_bytes``)."""
    return {name: array(np.asarray(a), ctx=device,
                        dtype=np.asarray(a).dtype)
            for name, a in arrays.items()}


def params_to_numpy(arrays):
    """``{name: NDArray}`` of either package -> ``{name: np.ndarray}``."""
    return {name: np.asarray(a.asnumpy()) for name, a in arrays.items()}
