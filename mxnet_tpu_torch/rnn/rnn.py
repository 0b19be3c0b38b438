"""RNN checkpoint helpers (counterpart of `mxnet_tpu/rnn/rnn.py`,
reference python/mxnet/rnn/rnn.py).

Checkpoints store *unpacked* (per-gate) weights so files remain loadable
when the cell implementation (fused vs unfused) changes — same contract as
the reference (`rnn.py:32-96`).
"""
from __future__ import annotations

from .. import model

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """Deprecated: use cell.unroll instead (reference rnn.py:26)."""
    import warnings
    warnings.warn("rnn_unroll is deprecated. Please call cell.unroll "
                  "directly.", DeprecationWarning)
    return cell.unroll(length=length, inputs=inputs,
                       begin_state=begin_state, layout=layout)


def _as_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save symbol + params with cell weights unpacked per gate."""
    for cell in _as_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint saved by save_rnn_checkpoint, re-packing weights
    for the given cells."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    for cell in _as_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback checkpointing with unpacked RNN weights
    (reference rnn.py:97; pairs with callback.do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
