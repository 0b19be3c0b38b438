"""Carrying weights between the JAX package and the port.

Parameter names and layouts are the same in both packages (the RNN op's
flat vector is the cuDNN layout in both), so moving a model across is a
typed copy onto a device. ``params_to_numpy`` reads either package's
``{name: NDArray}`` (a ``Module.get_params()`` half, say) back to the
host; ``params_from_numpy`` puts such a dict on a device of the port, and
the port's ``Module.set_params`` / ``init_params(arg_params=...)`` also
take the numpy dict as it is. A Gluon net's parameters cross the same
way: ``params_to_numpy({k: v.data() for k, v in
net.collect_params().items()})`` reads either package's net, and
``set_block_params`` fills a port net from such a dict, deferred
parameters included; that covers every Gluon block, the contrib cells of
``gluon.contrib.rnn`` (conv cells, ``LSTMPCell``) too, since both
packages name their parameters alike. Both packages read and write the
same ``.params`` container (`ndarray/utils.py`), which is the other way
across: a file of ``save_parameters``, ``save_params`` or ``export``
written by one loads into the other (``load_parameters``,
``load_params``, ``SymbolBlock.imports``).

Recurrent models cross the same way: a Gluon ``rnn.RNN``/``LSTM``/``GRU``
layer's per-(layer, direction) parameters by name, and a
``FusedRNNCell``'s flat ``parameters`` vector as it is. Per-gate arrays
(the form ``save_rnn_checkpoint`` writes) go through the cell's
``pack_weights``, as ``load_rnn_checkpoint`` does.
"""
from __future__ import annotations

import numpy as np

from .context import Context
from .ndarray.ndarray import array

__all__ = ["params_from_numpy", "params_to_numpy", "set_block_params"]


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


def set_block_params(block, arrays):
    """Copy ``{name: array}`` into every parameter of a Gluon ``block``
    of the port (names as ``collect_params()`` gives them); a parameter
    whose initialisation is still deferred takes the array as its
    initial value. Raises on a missing name."""
    for name, param in block.collect_params().items():
        if name not in arrays:
            raise KeyError("no array for parameter %s" % name)
        param.set_data(np.asarray(arrays[name]))
