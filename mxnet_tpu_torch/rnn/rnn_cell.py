"""Symbolic RNN cells.

Counterpart of `mxnet_tpu/rnn/rnn_cell.py` (reference
`python/mxnet/rnn/rnn_cell.py`): the cell classes, the fused and
per-gate weight layouts (``pack_weights``/``unpack_weights``) and the
unroll semantics, over the port's symbols.

- An unrolled cell (``cell.unroll``) is one graph of per-step symbols,
  which the executor runs op by op; none of them is a hand kernel.
- ``FusedRNNCell`` builds the ``RNN`` op (`ops/nn.py`), whose LSTM layers
  run the hand-written CUDA kernels on a CUDA tensor: K2 and K3 in
  training, K1 in inference (`ops/lstm_kernel.py`).
- ``begin_state`` makes batch-1 zero states that broadcast against the
  data batch at run time (shape inference has no unknown-batch
  placeholder; the reference uses 0-shapes resolved at bind time,
  `rnn_cell.py:189-222`), as the JAX package does.
"""
from __future__ import annotations

from .. import symbol
from .. import initializer as init

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "ConvRNNCell", "ConvLSTMCell",
           "ConvGRUCell", "BaseConvRNNCell"]


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Convert between a merged (batched over time) symbol and a per-step
    symbol list (reference rnn_cell.py:51-76 semantics)."""
    assert inputs is not None, \
        "unroll(inputs=None) is not supported; provide input symbols"
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert len(inputs.list_outputs()) == 1, \
                "unroll doesn't allow grouped symbols as inputs"
            inputs = symbol.SliceChannel(inputs, axis=in_axis,
                                         num_outputs=length,
                                         squeeze_axis=1)
            inputs = list(inputs)
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
            in_axis = axis
    if isinstance(inputs, symbol.Symbol) and axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNParams(object):
    """Container holding parameters (weights) of cells for sharing
    (reference rnn_cell.py:78)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract base class for RNN cells (reference rnn_cell.py:108)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        """Reset before re-using the cell for another graph."""
        self._init_counter = -1
        self._counter = -1
        if hasattr(self, "_cells"):
            for cell in self._cells:
                cell.reset()

    def __call__(self, inputs, states):
        """Unroll the RNN for one time step -> (output, new_states)."""
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        """shape and layout information of states"""
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial states for this cell. Zero states are created batch-1
        and broadcast at run time (see module docstring)."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            call_kwargs = dict(kwargs)
            if info is not None:
                shape = tuple(1 if d == 0 else d for d in info["shape"])
                call_kwargs.setdefault("shape", shape)
            if func is symbol.Variable:
                call_kwargs.pop("shape", None)
                states.append(func(name, **call_kwargs))
            else:
                states.append(func(name=name, **call_kwargs))
        return states

    def unpack_weights(self, args):
        """Split fused gate weights into per-gate arrays
        (reference rnn_cell.py:225)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights."""
        from ..ndarray import concat
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                concat(*weight, dim=0)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                concat(*bias, dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell for `length` steps (reference rnn_cell.py:297):
        one graph of ``length`` steps of the cell's symbols."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Simple recurrent cell: h' = act(W_i x + b_i + W_h h + b_h)
    (reference rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super(RNNCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order (in, forget, cell, out)
    (reference rnn_cell.py:408)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super(LSTMCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        # forget gate opens at init so long-range gradients flow from step 0
        self._hB = self.params.get(
            "h2h_bias", init=init.LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4,
                                          name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh",
                                         name="%sc" % name)
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh",
                                              name="%sstate_act" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order (reset, update, new)
    (reference rnn_cell.py:469)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super(GRUCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_state_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                       name="%sr_act" % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                        name="%sz_act" % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type="tanh",
                                       name="%sh_act" % name)
        next_h = (1.0 - update_gate) * next_h_tmp \
            + update_gate * prev_state_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer (bi)RNN over the ``RNN`` op (reference
    rnn_cell.py:536 wraps cuDNN)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super(FusedRNNCell, self).__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """Slice the flat parameter vector into per-layer/gate arrays,
        following the layout of ops/nn.py `_unpack_rnn_params`: all
        weights (layer-major, direction-minor, i2h then h2h), then all
        biases."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                in_sz = li if layer == 0 else lh * b
                for group_name, sz in (("i2h", in_sz), ("h2h", lh)):
                    name = "%s%s%d_%s_weight" % (self._prefix, direction,
                                                 layer, group_name)
                    args[name] = arr[p:p + self._num_gates * lh * sz] \
                        .reshape((self._num_gates * lh, sz))
                    p += self._num_gates * lh * sz
        for layer in range(self._num_layers):
            for direction in directions:
                for group_name in ("i2h", "h2h"):
                    name = "%s%s%d_%s_bias" % (self._prefix, direction,
                                               layer, group_name)
                    args[name] = arr[p:p + self._num_gates * lh]
                    p += self._num_gates * lh
        return args

    def unpack_weights(self, args):
        args = args.copy()
        arr = args.pop(self._parameter.name)
        li = self._infer_input_size(arr)
        for name, nd in self._slice_weights(arr, li, self._num_hidden).items():
            args[name] = nd.copy() if hasattr(nd, "copy") else nd
        return args

    def _infer_input_size(self, arr):
        """Recover the first-layer input width from the flat size."""
        total = arr.shape[0]
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        size1 = (self._num_layers - 1) * b * (m * h * (h + b * h) + 2 * m * h) \
            if self._num_layers > 1 else 0
        rem = total - size1
        # rem = b*(m*h*(li + h) + 2*m*h)  ->  li
        li = (rem // b - 2 * m * h) // (m * h) - h
        return int(li)

    def pack_weights(self, args):
        from ..ndarray import concat
        args = args.copy()
        pieces_w, pieces_b = [], []
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group_name in ("i2h", "h2h"):
                    w = args.pop("%s%s%d_%s_weight" % (
                        self._prefix, direction, layer, group_name))
                    pieces_w.append(w.reshape((-1,)))
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group_name in ("i2h", "h2h"):
                    bias = args.pop("%s%s%d_%s_bias" % (
                        self._prefix, direction, layer, group_name))
                    pieces_b.append(bias.reshape((-1,)))
        args[self._parameter.name] = concat(*(pieces_w + pieces_b), dim=0)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped; use unroll() "
            "(reference rnn_cell.py:650 raises too)")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC -> TNC for the RNN op
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        if self._mode == "lstm":
            states = {"state": states[0], "state_cell": states[1]}
        else:
            states = {"state": states[0]}
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **states)
        attr = {"__layout__": "LNC"}
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
            outputs, _ = _normalize_sequence(length, outputs, layout,
                                             merge_outputs, in_layout="NTC")
        else:
            outputs, _ = _normalize_sequence(length, outputs, layout,
                                             merge_outputs, in_layout="TNC")
        return outputs, states

    def unfuse(self):
        """Equivalent SequentialRNNCell of unfused cells
        (reference rnn_cell.py:712)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%s_%d" % (self._prefix,
                                                  self._mode, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (
                                          self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack multiple cells (reference rnn_cell.py:748)."""

    def __init__(self, params=None):
        super(SequentialRNNCell, self).__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell), \
                "BidirectionalCell cannot be stepped; use unroll"
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        # delegate to each child's unroll (so Bidirectional/Fused members
        # work), threading layer outputs to the next cell's inputs
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on cell output (reference rnn_cell.py:827)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super(DropoutCell, self).__init__(prefix, params)
        assert isinstance(dropout, (int, float)), \
            "dropout probability must be a number"
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            # Dropout has two outputs (output, mask) — keep the output
            inputs = symbol.Dropout(data=inputs, p=self.dropout)[0]
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return super(DropoutCell, self).unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Base class for cells wrapping another cell
    (reference rnn_cell.py:867)."""

    def __init__(self, base_cell):
        super(ModifierCell, self).__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:909): randomly keep
    previous state values."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout; unfuse() first"
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout; wrap the cells instead"
        super(ZoneoutCell, self).__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super(ZoneoutCell, self).reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        # Dropout has two outputs (output, mask) — keep the scaled output
        mask = lambda p, like: symbol.Dropout(symbol.ones_like(like), p=p)[0]
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros(shape=(1, 1))
        output = symbol.where(mask(p_outputs, next_output), next_output,
                              prev_output) if p_outputs != 0. \
            else next_output
        new_states = [symbol.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self.prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds residual connection output = base(input) + input
    (reference rnn_cell.py:957)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name="%s_plus_residual" % output.name)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, symbol.Symbol) \
            if merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            outputs = [symbol.elemwise_add(o, i)
                       for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over the sequence in opposite directions and concat
    outputs (reference rnn_cell.py:998)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super(BidirectionalCell, self).__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params, \
                "Either specify params for BidirectionalCell or child cells, not both."
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l],
            layout=layout, merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout,
            merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = (isinstance(l_outputs, symbol.Symbol)
                             and isinstance(r_outputs, symbol.Symbol))
            l_outputs, _ = _normalize_sequence(None, l_outputs, layout,
                                               merge_outputs)
            r_outputs, _ = _normalize_sequence(None, r_outputs, layout,
                                               merge_outputs)
        if merge_outputs:
            reverse_kw = {"axis": layout.find("T")}
            r_outputs = symbol.reverse(r_outputs, **reverse_kw)
            outputs = symbol.Concat(l_outputs, r_outputs, dim=2,
                                    name="%sout" % self._output_prefix)
        else:
            outputs = [symbol.Concat(l_o, r_o, dim=1,
                                     name="%st%d" % (self._output_prefix, i))
                       for i, (l_o, r_o) in enumerate(
                           zip(l_outputs, reversed(r_outputs)))]
        states = l_states + r_states
        return outputs, states


class BaseConvRNNCell(BaseRNNCell):
    """Convolutional RNN cells base (reference rnn_cell.py:1094): gates
    are convolutions over spatial feature maps instead of dense layers."""

    def __init__(self, input_shape, num_hidden, h2h_kernel, h2h_dilate,
                 i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                 activation, prefix="", params=None, conv_layout="NCHW"):
        super(BaseConvRNNCell, self).__init__(prefix=prefix, params=params)
        self._h2h_kernel = h2h_kernel
        self._h2h_dilate = h2h_dilate
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._i2h_kernel = i2h_kernel
        self._i2h_stride = i2h_stride
        self._i2h_pad = i2h_pad
        self._i2h_dilate = i2h_dilate
        self._num_hidden = num_hidden
        self._input_shape = input_shape
        self._conv_layout = conv_layout
        self._activation = activation
        # infer state shape from the i2h conv geometry
        data = symbol.Variable("tmp_for_shape_infer")
        self._state_shape = symbol.Convolution(
            data=data, num_filter=self._num_hidden,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate,
            no_bias=True).infer_shape(
                tmp_for_shape_infer=(1,) + tuple(input_shape))[1][0]
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": self._state_shape, "__layout__": self._conv_layout}
                for _ in range(self._n_states)]

    @property
    def _n_states(self):
        return 1

    def _conv_forward(self, inputs, states, name, num_gates):
        i2h = symbol.Convolution(data=inputs,
                                 num_filter=self._num_hidden * num_gates,
                                 kernel=self._i2h_kernel,
                                 stride=self._i2h_stride,
                                 pad=self._i2h_pad,
                                 dilate=self._i2h_dilate,
                                 weight=self._iW, bias=self._iB,
                                 name="%si2h" % name)
        h2h = symbol.Convolution(data=states[0],
                                 num_filter=self._num_hidden * num_gates,
                                 kernel=self._h2h_kernel,
                                 dilate=self._h2h_dilate,
                                 pad=self._h2h_pad,
                                 stride=(1, 1),
                                 weight=self._hW, bias=self._hB,
                                 name="%sh2h" % name)
        return i2h, h2h


class ConvRNNCell(BaseConvRNNCell):
    """Convolutional vanilla RNN cell (reference rnn_cell.py:1176)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="ConvRNN_", params=None, conv_layout="NCHW"):
        super(ConvRNNCell, self).__init__(
            input_shape=input_shape, num_hidden=num_hidden,
            h2h_kernel=h2h_kernel, h2h_dilate=h2h_dilate,
            i2h_kernel=i2h_kernel, i2h_stride=i2h_stride,
            i2h_pad=i2h_pad, i2h_dilate=i2h_dilate, activation=activation,
            prefix=prefix, params=params, conv_layout=conv_layout)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name, 1)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class ConvLSTMCell(BaseConvRNNCell):
    """Convolutional LSTM (reference rnn_cell.py:1253; Shi et al. 2015)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="ConvLSTM_", params=None, forget_bias=1.0,
                 conv_layout="NCHW"):
        super(ConvLSTMCell, self).__init__(
            input_shape=input_shape, num_hidden=num_hidden,
            h2h_kernel=h2h_kernel, h2h_dilate=h2h_dilate,
            i2h_kernel=i2h_kernel, i2h_stride=i2h_stride,
            i2h_pad=i2h_pad, i2h_dilate=i2h_dilate, activation=activation,
            prefix=prefix, params=params, conv_layout=conv_layout)
        self._hB = self.params.get(
            "h2h_bias", init=init.LSTMBias(forget_bias=forget_bias))

    @property
    def _n_states(self):
        return 2

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name, 4)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(
            gates, num_outputs=4,
            axis=self._conv_layout.find("C"), name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = self._get_activation(slice_gates[2], self._activation)
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(next_c, self._activation)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Convolutional GRU (reference rnn_cell.py:1348)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="ConvGRU_", params=None, conv_layout="NCHW"):
        super(ConvGRUCell, self).__init__(
            input_shape=input_shape, num_hidden=num_hidden,
            h2h_kernel=h2h_kernel, h2h_dilate=h2h_dilate,
            i2h_kernel=i2h_kernel, i2h_stride=i2h_stride,
            i2h_pad=i2h_pad, i2h_dilate=i2h_dilate, activation=activation,
            prefix=prefix, params=params, conv_layout=conv_layout)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name, 3)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, axis=self._conv_layout.find("C"),
            name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, axis=self._conv_layout.find("C"),
            name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = self._get_activation(i2h + reset_gate * h2h,
                                          self._activation)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]
