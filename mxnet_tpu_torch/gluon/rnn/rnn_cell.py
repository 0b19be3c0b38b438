"""Gluon RNN cells.

Counterpart of `mxnet_tpu/gluon/rnn/rnn_cell.py` (reference
`python/mxnet/gluon/rnn/rnn_cell.py`): the ``RecurrentCell`` base,
``RNNCell``/``LSTMCell``/``GRUCell``, ``SequentialRNNCell``,
``DropoutCell``, ``ZoneoutCell``, ``ResidualCell`` and
``BidirectionalCell``. ``unroll`` runs the cell step by step; each step's
ops are the port's elementwise and matrix ops (no hand kernel).
"""
from __future__ import annotations

from ..block import HybridBlock
from ..nn.basic_layers import _first

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        # the inputs' device (a list of steps: the first one's), not the
        # current context's
        first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        ctx = getattr(first, "ctx", None)
        from ... import ndarray as nd

        def zeros_fn(**kwargs):
            shape = kwargs.pop("shape")
            return F.zeros(shape=shape, **kwargs) if hasattr(F, "var") else \
                nd.zeros(shape, ctx=ctx)
        begin_state = cell.begin_state(func=zeros_fn, batch_size=batch_size)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    from ...ndarray import NDArray
    from ...symbol import Symbol
    if isinstance(inputs, (NDArray, Symbol)):
        F = _F_of(inputs)
        batch_size = inputs.shape[batch_axis] if isinstance(inputs, NDArray) else 0
        if merge is False:
            if isinstance(inputs, NDArray):
                assert length is None or inputs.shape[in_axis] == length
                inputs = list(_split_seq(inputs, in_axis))
            else:
                inputs = list(F.SliceChannel(inputs, axis=in_axis,
                                             num_outputs=length,
                                             squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        F = _F_of(inputs[0])
        batch_size = inputs[0].shape[batch_axis - 1 if batch_axis > axis else batch_axis] \
            if isinstance(inputs[0], NDArray) else 0
        if merge is True:
            inputs = F.stack(*inputs, axis=axis)
            in_axis = axis
    if isinstance(inputs, (NDArray, Symbol)) and axis != in_axis:
        inputs = F.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis, F, batch_size


def _split_seq(x, axis):
    T = x.shape[axis]
    outs = x.split(T, axis=axis, squeeze_axis=True)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    return outs


def _F_of(x):
    from ...ndarray import NDArray
    from ... import ndarray as nd_mod, symbol as sym_mod
    return nd_mod if isinstance(x, NDArray) else sym_mod


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    @property
    def _curr_prefix(self):
        return "%st%d_" % (self.prefix, self._counter)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base cell " \
            "cannot be called directly. Call the modifier cell instead."
        from ...ndarray import zeros as nd_zeros
        if func is None:
            def func(**kw):
                shape = kw.pop("shape")
                return nd_zeros(shape, **{k: v for k, v in kw.items()
                                          if k in ("ctx", "dtype")})
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name="%sbegin_state_%d" % (self._prefix,
                                                          self._init_counter),
                               **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs, batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if valid_length is not None:
            outputs = F.stack(*outputs, axis=axis)
            outputs = F.SequenceMask(outputs, valid_length,
                                     use_sequence_length=True, axis=axis)
            if merge_outputs is False:
                outputs = list(_split_seq(outputs, axis)) if not hasattr(F, "var") \
                    else list(F.SliceChannel(outputs, axis=axis,
                                             num_outputs=length, squeeze_axis=1))
        elif merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    def __init__(self, hidden_size, activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _infer_shapes(self, inputs, states):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size, name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size, name=prefix + "h2h")
        output = self._get_activation(F, i2h + h2h, self._activation,
                                      name=prefix + "out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def _infer_shapes(self, inputs, states):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4, axis=-1
                                     if not hasattr(F, "var") else 1,
                                     name=prefix + "slice")
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _infer_shapes(self, inputs, states):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (3 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "h2h")
        split_ax = -1 if not hasattr(F, "var") else 1
        i2h_r, i2h_z, i2h = list(F.SliceChannel(i2h, num_outputs=3,
                                                axis=split_ax,
                                                name=prefix + "i2h_slice"))
        h2h_r, h2h_z, h2h = list(F.SliceChannel(h2h, num_outputs=3,
                                                axis=split_ax,
                                                name=prefix + "h2h_slice"))
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        return s.format(name=self.__class__.__name__,
                        modstr="\n".join(
                            ["({i}): {m}".format(i=i, m=m)
                             for i, m in enumerate(self._children.values())]))

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._children.values())
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout, None)
        num_cells = len(self._children)
        begin_state = _get_begin_state(self, F, begin_state, inputs, batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(length, inputs=inputs,
                                         begin_state=states, layout=layout,
                                         merge_outputs=None if i < num_cells - 1
                                         else merge_outputs,
                                         valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float), "rate must be a number"
        self._rate = rate
        self._axes = axes

    def __repr__(self):
        return "{name}(rate={_rate}, axes={_axes})".format(
            name=self.__class__.__name__, **self.__dict__)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = _first(F.Dropout(inputs, p=self._rate, axes=self._axes))
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified twice" \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. Use ZoneoutCell on " \
            "the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def __repr__(self):
        return "{name}(p_out={zoneout_outputs}, p_state={zoneout_states}, " \
               "{base_cell})".format(name=self.__class__.__name__,
                                     **self.__dict__)

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, \
            self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            m = _first(F.Dropout(F.ones_like(like), p=p))
            return m

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output, prev_output) \
            if p_outputs != 0. else next_output
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0. else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        inputs, axis, F, _ = _format_sequence(length, inputs, layout,
                                              not isinstance(outputs, list))
        if isinstance(outputs, list):
            outputs = [o + i for o, i in zip(outputs, inputs)]
        else:
            outputs = outputs + inputs
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please use unroll")

    def __repr__(self):
        s = "{name}(forward={l_cell}, backward={r_cell})"
        children = list(self._children.values())
        return s.format(name=self.__class__.__name__,
                        l_cell=children[0], r_cell=children[1])

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs, layout,
                                                       False)
        begin_state = _get_begin_state(self, F, begin_state, inputs, batch_size)
        states = begin_state
        children = list(self._children.values())
        l_cell, r_cell = children[0], children[1]
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info(batch_size))],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_inputs = list(reversed(inputs))
        r_outputs, r_states = r_cell.unroll(
            length, inputs=r_inputs,
            begin_state=states[len(l_cell.state_info(batch_size)):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs = list(reversed(r_outputs))
        outputs = [F.Concat(l_o, r_o, dim=1 if hasattr(F, "var") else -1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=axis)
        states = l_states + r_states
        return outputs, states

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
