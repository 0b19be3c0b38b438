"""Fused Gluon RNN layers.

Counterpart of `mxnet_tpu/gluon/rnn/rnn_layer.py` (reference
`python/mxnet/gluon/rnn/rnn_layer.py`): ``RNN``, ``LSTM`` and ``GRU`` with
the same per-(layer, direction) parameters, concatenated at each call
into the ``RNN`` op's flat cuDNN layout (`ops/nn.py`). An LSTM layer runs
the hand-written CUDA kernels on a CUDA tensor: K2 and K3 under
``autograd.record()``, K1 otherwise, also inside a hybridized block's
CUDA graph.
"""
from __future__ import annotations

from ..block import HybridBlock
from ...ops.nn import _gates

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = _gates(mode)
        ng, ni, nh = self._gates, input_size, hidden_size
        # per-(layer,dir) split parameters like the reference, concatenated
        # into the fused flat vector at forward time
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(shape[1] if shape[1] else None,
                                      shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def _infer_shapes(self, inputs, *states):
        ni = inputs.shape[2] if self._layout == "TNC" else inputs.shape[2]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                p = getattr(self, "{}{}_i2h_weight".format(j, i))
                if p.shape[1] == 0:
                    p.shape = (ng * nh, ni)
            ni = nh * self._dir

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ...ndarray import zeros as nd_zeros
        if func is None:
            def func(**kw):
                shape = kw.pop("shape")
                return nd_zeros(shape, **{k: v for k, v in kw.items()
                                          if k in ("ctx", "dtype")})
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name="%sh0_%d" % (self.prefix, i), **info))
        return states

    def _collect_flat_params(self, F, kwargs):
        """Concatenate split params into the fused cuDNN-layout flat vector."""
        order = []
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                order.append(kwargs["{}{}_i2h_weight".format(j, i)].reshape(-1))
                order.append(kwargs["{}{}_h2h_weight".format(j, i)].reshape(-1))
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                order.append(kwargs["{}{}_i2h_bias".format(j, i)])
                order.append(kwargs["{}{}_h2h_bias".format(j, i)])
        return F.Concat(*order, dim=0)

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        skip_states = states is None
        if skip_states:
            batch_size = inputs.shape[1] if hasattr(inputs, "shape") and \
                inputs.shape else 0
            states = self.begin_state(batch_size, ctx=getattr(inputs, "ctx", None))
        if not isinstance(states, (list, tuple)):
            states = [states]
        flat = self._collect_flat_params(F, kwargs)
        rnn_args = [inputs, flat] + list(states)
        outs = F.RNN(*rnn_args, state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, p=self._dropout,
                     state_outputs=True, mode=self._mode)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        outputs, states_out = outs[0], list(outs[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, states_out


class RNN(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
