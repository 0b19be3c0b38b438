"""Gluon contrib RNN cells (counterpart of `mxnet_tpu/gluon/contrib/rnn.py`,
reference `python/mxnet/gluon/contrib/rnn/`): the
Conv{1,2,3}D{RNN,LSTM,GRU}Cell family, ``VariationalDropoutCell`` and
``LSTMPCell``, over the port's `gluon/rnn` cells.

Conv cells take an explicit ``input_shape`` (C, spatial...) like the
reference, so state shapes are known at construction; gates are
convolutions over the feature maps (the ``Convolution`` op, cuDNN on the
card: no hand kernel). ``VariationalDropoutCell`` draws each mask once,
at its first step, and keeps it until ``reset()``.
"""
from __future__ import annotations

from ..rnn.rnn_cell import HybridRecurrentCell, ModifierCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(HybridRecurrentCell):
    """Abstract conv-gated recurrent cell (reference conv_rnn_cell.py:37)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, activation="tanh",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._dims = dims
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        for k in self._h2h_kernel:
            assert k % 2 == 1, \
                "h2h kernel dims must be odd to preserve the state shape"
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        in_c = self._input_shape[0]
        # state spatial dims from the i2h conv geometry (stride 1)
        self._state_shape = (hidden_channels,) + tuple(
            s + 2 * p - d * (k - 1)
            for s, p, d, k in zip(self._input_shape[1:], self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        ng = self._num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(ng * hidden_channels, in_c)
            + self._i2h_kernel, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(ng * hidden_channels, hidden_channels)
            + self._h2h_kernel, init=h2h_weight_initializer,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ng * hidden_channels,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ng * hidden_channels,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    @property
    def _num_gates(self):
        raise NotImplementedError

    @property
    def _num_states(self):
        return 1

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[3 - self._dims:]}
                for _ in range(self._num_states)]

    def _conv_gates(self, F, inputs, states, i2h_weight, h2h_weight,
                    i2h_bias, h2h_bias):
        ng = self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel,
                            num_filter=ng * self._hidden_channels,
                            pad=self._i2h_pad, dilate=self._i2h_dilate)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel,
                            num_filter=ng * self._hidden_channels,
                            pad=self._h2h_pad, dilate=self._h2h_dilate)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    @property
    def _num_gates(self):
        return 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    @property
    def _num_gates(self):
        return 4

    @property
    def _num_states(self):
        return 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        slices = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.Activation(slices[0], act_type="sigmoid")
        forget_gate = F.Activation(slices[1], act_type="sigmoid")
        in_transform = self._get_activation(F, slices[2], self._activation)
        out_gate = F.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    @property
    def _num_gates(self):
        return 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_o = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_o = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = self._get_activation(F, i2h_o + reset * h2h_o,
                                          self._activation)
        next_h = (1.0 - update) * next_h_tmp + update * states[0]
        return next_h, [next_h]


def _make_conv_cell(base, dims, alias):
    class Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros",
                     h2h_bias_initializer="zeros", activation="tanh",
                     prefix=None, params=None):
            super().__init__(
                input_shape=input_shape, hidden_channels=hidden_channels,
                i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                h2h_dilate=h2h_dilate,
                i2h_weight_initializer=i2h_weight_initializer,
                h2h_weight_initializer=h2h_weight_initializer,
                i2h_bias_initializer=i2h_bias_initializer,
                h2h_bias_initializer=h2h_bias_initializer, dims=dims,
                activation=activation, prefix=prefix, params=params)

    Cell.__name__ = alias
    Cell.__qualname__ = alias
    Cell.__doc__ = ("%s (reference gluon/contrib/rnn/conv_rnn_cell.py): "
                    "conv-gated recurrent cell over %dD feature maps."
                    % (alias, dims))
    return Cell


Conv1DRNNCell = _make_conv_cell(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make_conv_cell(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make_conv_cell(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make_conv_cell(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make_conv_cell(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make_conv_cell(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make_conv_cell(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make_conv_cell(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make_conv_cell(_ConvGRUCell, 3, "Conv3DGRUCell")


class VariationalDropoutCell(ModifierCell):
    """Apply the SAME dropout mask at every step (Gal & Ghahramani;
    reference gluon/contrib/rnn/rnn_cell.py:26)."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _mask(self, F, name, like, p):
        mask = getattr(self, name)
        if mask is None:
            # Dropout exposes (output, mask); keep the scaled output
            mask = F.Dropout(F.ones_like(like), p=p)[0]
            setattr(self, name, mask)
        return mask

    def hybrid_forward(self, F, inputs, states):
        if self.drop_inputs:
            inputs = inputs * self._mask(F, "drop_inputs_mask", inputs,
                                         self.drop_inputs)
        if self.drop_states:
            states = [states[0] * self._mask(F, "drop_states_mask",
                                             states[0], self.drop_states)] \
                + list(states[1:])
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            output = output * self._mask(F, "drop_outputs_mask", output,
                                         self.drop_outputs)
        return output, states

    def _alias(self):
        return "vardrop"


class LSTMPCell(HybridRecurrentCell):
    """LSTM with projection (LSTMP, used in speech models)."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(4 * hidden_size, projection_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2r_weight = self.params.get("h2r_weight",
                                          shape=(projection_size, hidden_size),
                                          init=h2r_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _infer_shapes(self, inputs, states):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4,
                                     axis=-1 if not hasattr(F, "var") else 1)
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
