"""Minimal inference ("predict") API.

Counterpart of `mxnet_tpu/predict.py`, the reference's standalone predict
C API (`include/mxnet/c_predict_api.h`) as a Python class: create a
predictor from a symbol JSON string plus a `.params` blob, set inputs by
name, run forward, read outputs.

==========================  =================================
reference C function         :class:`Predictor` method
==========================  =================================
``MXPredCreate``             ``Predictor(...)``
``MXPredCreatePartialOut``   ``Predictor(..., output_names=[...])``
``MXPredReshape``            ``Predictor.reshape``
``MXPredGetOutputShape``     ``Predictor.get_output_shape``
``MXPredSetInput``           ``Predictor.set_input``
``MXPredForward``            ``Predictor.forward``
``MXPredGetOutput``          ``Predictor.get_output``
``MXPredFree``               ``Predictor.close`` / del
==========================  =================================

The bound executor's inference forward is one compiled program
(`executor.py` over `compiled.py`): on the card one captured CUDA graph
per input-shape signature, so a repeated ``forward`` is one replay. A
predictor, its ``reshape`` and its ``sibling``s share that program, so
each shape is one signature and all their graphs share one graph pool;
two predictors built separately (the serving engine's replicas) have a
program each, so their replays never wait on each other's lock.

The ``_c_*`` functions at the end are the boundary of the ``MXPred*`` C
ABI (`csrc/c_predict_api.cc`, built by `native.py`), which embeds CPython
and calls them.

The device defaults to ``gpu(0)``; without that CUDA device the
constructor raises unless the caller passes ``ctx=cpu()``.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .context import Context, cpu, gpu
from . import ndarray as nd
from .symbol import symbol as _symbol

__all__ = ["Predictor"]


class Predictor:
    """Inference-only executor over (symbol JSON, params blob).

    Parameters
    ----------
    symbol_json : str
        Symbol JSON (reference `symbol_json_str` arg of MXPredCreate).
    param_bytes : bytes or str or dict
        The `.params` container as in-memory bytes, a file path, or an
        already-loaded ``{'arg:name'/'name' -> NDArray}`` dict.
    ctx : Context, optional
        Device; ``gpu(0)`` when omitted.
    input_shapes : dict[str, tuple]
        Shapes for every data input.
    output_names : list[str], optional
        Bind only these internal outputs (MXPredCreatePartialOut).
    """

    def __init__(self, symbol_json, param_bytes, ctx=None, input_shapes=None,
                 output_names=None):
        self._ctx = ctx if ctx is not None else gpu(0)
        if not isinstance(self._ctx, Context):
            raise MXNetError("ctx must be a Context")
        self._ctx.torch_device()   # no such CUDA device: raise here
        sym = _symbol.load_json(symbol_json)
        if output_names:
            internals = sym.get_internals()
            outs = [internals[n if n.endswith("_output") else n + "_output"]
                    for n in output_names]
            sym = _symbol.Group(outs) if len(outs) > 1 else outs[0]
        self._symbol = sym
        self._params = self._load_params(param_bytes)
        self._input_shapes = dict(input_shapes or {})
        self._settable = None
        self._exec = None
        self._bind()

    @staticmethod
    def _load_params(param_bytes):
        if isinstance(param_bytes, dict):
            raw = param_bytes
        elif isinstance(param_bytes, (bytes, bytearray, memoryview)):
            raw = nd.load_frombuffer(bytes(param_bytes))
        elif isinstance(param_bytes, str):
            raw = nd.load(param_bytes)
        else:
            raise MXNetError("param_bytes must be bytes, a path, or a dict")
        if not isinstance(raw, dict):
            raise MXNetError(".params blob must carry names "
                             "(saved as a dict)")
        # the reference predict API accepts prefixed and bare names
        return {k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k:
                v for k, v in raw.items()}

    def _bind(self, shared_exec=None):
        self._settable = None   # _input_names() cache: recompute per bind
        shapes = dict(self._input_shapes)
        for name in self._symbol.list_arguments():
            if name in self._params and name not in shapes:
                shapes[name] = self._params[name].shape
        ex = self._symbol.simple_bind(self._ctx, grad_req="null",
                                      shared_exec=shared_exec, **shapes)
        for name, arr in self._params.items():
            # an argument, else an auxiliary state (BatchNorm's moving
            # statistics, which `export` writes as arg:)
            dst = ex.arg_dict.get(name, ex.aux_dict.get(name))
            if dst is None:
                continue
            if shared_exec is not None and \
                    (dst is shared_exec.arg_dict.get(name)
                     or dst is shared_exec.aux_dict.get(name)):
                continue   # same device buffer: already holds the weight
            dst[:] = arr
        self._exec = ex

    def _input_names(self):
        """Settable keys: declared input shapes plus any argument the
        loaded params did NOT provide (weights are not settable)."""
        if self._settable is None:
            self._settable = set(self._input_shapes) | {
                n for n in self._symbol.list_arguments()
                if n not in self._params}
        return self._settable

    def set_input(self, name, data):
        """MXPredSetInput: copy host data into the named input."""
        if name not in self._exec.arg_dict or name not in self._input_names():
            raise MXNetError("no input named %r; inputs are %s"
                             % (name, sorted(self._input_names())))
        data = np.asarray(data, dtype=self._exec.arg_dict[name].dtype)
        if tuple(data.shape) != self._exec.arg_dict[name].shape:
            raise MXNetError(
                "input %r shape %s != bound shape %s (use reshape())"
                % (name, tuple(data.shape), self._exec.arg_dict[name].shape))
        self._exec.arg_dict[name][:] = data

    def forward(self, **inputs):
        """MXPredForward; keyword inputs are set_input + forward in one."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._exec.forward(is_train=False)

    def _check_output_index(self, index):
        n = self.num_outputs
        if not 0 <= index < n:
            raise MXNetError("output index %d out of range for %d "
                             "output%s" % (index, n, "" if n == 1 else "s"))

    def get_output_shape(self, index=0):
        """MXPredGetOutputShape."""
        index = int(index)
        self._check_output_index(index)
        if self._exec.outputs:
            return tuple(self._exec.outputs[index].shape)
        shapes = dict(self._input_shapes)
        for name, arr in self._params.items():
            shapes.setdefault(name, arr.shape)
        return tuple(self._symbol.infer_shape(**shapes)[1][index])

    def get_output(self, index=0):
        """MXPredGetOutput: returns a host numpy array."""
        index = int(index)
        self._check_output_index(index)
        if not self._exec.outputs:
            raise MXNetError("call forward() before get_output()")
        return self._exec.outputs[index].asnumpy()

    @property
    def num_outputs(self):
        return len(self._symbol.list_outputs())

    def _check_input_names(self, input_shapes):
        unknown = sorted(set(input_shapes) - self._input_names())
        if unknown:
            raise MXNetError("unknown input name%s %s; valid inputs are %s"
                             % ("" if len(unknown) == 1 else "s",
                                ", ".join(map(repr, unknown)),
                                sorted(self._input_names())))

    def reshape(self, input_shapes):
        """MXPredReshape: rebind for new input shapes, sharing the
        loaded parameters' device buffers (no reload, no recopy)."""
        self._check_input_names(input_shapes)
        self._input_shapes.update(input_shapes)
        self._bind(shared_exec=self._exec)

    def sibling(self, input_shapes):
        """A NEW predictor over the same symbol and weights, bound for
        ``input_shapes``; it shares the weights' device buffers with this
        one, so N bucket predictors cost one copy of the weights. The
        serving engine binds one sibling per batch bucket."""
        if self._exec is None:
            raise MXNetError("sibling() on a closed Predictor: no bound "
                             "executor to share weights with")
        self._check_input_names(input_shapes)
        new = Predictor.__new__(Predictor)
        new._ctx = self._ctx
        new._symbol = self._symbol
        new._params = self._params          # shared weights
        new._input_shapes = dict(self._input_shapes)
        new._input_shapes.update({k: tuple(int(d) for d in s)
                                  for k, s in input_shapes.items()})
        new._settable = None
        new._exec = None
        new._bind(shared_exec=self._exec)
        return new

    def close(self):
        """MXPredFree."""
        self._exec = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _c_create(symbol_json, param_bytes, dev_type, dev_id, input_keys,
              input_shapes, output_names):
    """MXPredCreate(PartialOut) device mapping: dev_type 1 = cpu,
    2 = gpu (CUDA); a gpu request without that device raises."""
    if dev_type not in (1, 2):
        raise MXNetError("unknown dev_type %r (1 = cpu, 2 = gpu)"
                         % (dev_type,))
    ctx = gpu(dev_id) if dev_type == 2 else cpu(dev_id)
    shapes = {k: tuple(int(d) for d in s)
              for k, s in zip(input_keys, input_shapes)}
    return Predictor(symbol_json, param_bytes, ctx=ctx, input_shapes=shapes,
                     output_names=list(output_names) or None)


def _c_set_input(pred, key, memview, size):
    """MXPredSetInput: ``size`` float32 values from a C buffer."""
    arr = np.frombuffer(memview, dtype=np.float32, count=int(size))
    bound = pred._exec.arg_dict.get(key)
    if bound is None or key not in pred._input_names():
        raise MXNetError("no input named %r; inputs are %s"
                         % (key, sorted(pred._input_names())))
    if int(size) != int(np.prod(bound.shape)):
        raise MXNetError("input %r size %d != bound size %d"
                         % (key, int(size), int(np.prod(bound.shape))))
    pred.set_input(key, arr.reshape(bound.shape))


def _c_get_output_bytes(pred, index):
    """MXPredGetOutput: the output as float32 bytes."""
    out = np.ascontiguousarray(pred.get_output(int(index)),
                               dtype=np.float32)
    return out.tobytes()


def _c_output_shape(pred, index):
    return tuple(int(d) for d in pred.get_output_shape(int(index)))


def _c_reshape(pred, input_keys, input_shapes):
    """MXPredReshape: a NEW predictor sharing the loaded parameters' device
    buffers (and the compiled program); the original handle keeps its
    shapes, as in the reference's c_predict_api."""
    return pred.sibling({k: tuple(int(d) for d in s)
                         for k, s in zip(input_keys, input_shapes)})
