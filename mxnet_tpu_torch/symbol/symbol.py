"""Symbol: the declarative graph IR.

Counterpart of `mxnet_tpu/symbol/symbol.py`: a Symbol is a DAG over
registered ops with free variables, serialised in the reference's JSON
graph format, so a graph either package writes loads in the other.
Shape inference runs each op's fcompute on ``meta`` tensors (shapes and
dtypes, no data) where the JAX package uses ``jax.eval_shape``; a meta
tensor is not on a CUDA device, so no hand kernel is launched for it.
Variables consumed at an op's ``mutate_aux`` positions (BatchNorm's moving
statistics) are auxiliary states, not arguments, and only an op's visible
outputs take part in composition. Arithmetic and comparison operators
build ``broadcast_*`` and scalar nodes (so ``==`` gives a Symbol, and a
Symbol hashes by identity), and the tensor methods (``reshape``,
``astype``, ``sum``, ...) build their ops, as in the JAX package.
``infer_type`` is the JAX package's: the given argument types, f32 for
the rest and for every output. ``eval`` binds on ``cpu()`` by default.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..base import MXNetError, dtype_np, torch_dtype
from ..attribute import AttrScope
from ..name import NameManager
from ..ops.registry import _OPS, get_op
from . import infer as _infer

__all__ = ["Symbol", "var", "Variable", "Group", "load_json", "load",
           "create"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "_aux_mark")

    def __init__(self, op, name, attrs, inputs):
        self.op = op                    # op name or None for variable
        self.name = name
        self.attrs = attrs or {}
        self.inputs = inputs            # list[(node, out_idx)]
        self.num_outputs = 1 if op is None else \
            get_op(op).n_out(attrs or {})
        self._aux_mark = False

    def is_var(self):
        return self.op is None


class Symbol:
    def __init__(self, outputs):
        # list of (node, out_index)
        self._outputs = list(outputs)

    # -- outputs ---------------------------------------------------------
    @property
    def name(self):
        node, idx = self._outputs[0]
        if len(self._outputs) > 1:
            return None
        if node.num_outputs == 1:
            return node.name
        return _output_name(node, idx)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError("Cannot find output %s" % index)
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def get_internals(self):
        return Symbol([(n, i) for n in self._topo_nodes()
                       for i in range(n.num_outputs)])

    def get_children(self):
        """The inputs of the first output's node as one Symbol (None for
        a variable)."""
        node, _ = self._outputs[0]
        return Symbol(list(node.inputs)) if node.inputs else None

    # -- graph walk ------------------------------------------------------
    def _topo_nodes(self):
        seen = set()
        order = []
        for head, _ in self._outputs:
            stack = [(head, False)]
            while stack:
                n, processed = stack.pop()
                if processed:
                    order.append(n)
                    continue
                if id(n) in seen:
                    continue
                seen.add(id(n))
                stack.append((n, True))
                for inp, _ in reversed(n.inputs):
                    if id(inp) not in seen:
                        stack.append((inp, False))
        return order

    def _mark_aux(self):
        """Variables consumed at an op's ``mutate_aux`` positions are
        auxiliary states (reference ListAuxiliaryStates)."""
        for n in self._topo_nodes():
            if n.is_var() or n.op not in _OPS:
                continue
            for ai in get_op(n.op).mutate_aux:
                if ai < len(n.inputs) and n.inputs[ai][0].is_var():
                    n.inputs[ai][0]._aux_mark = True

    def list_arguments(self):
        self._mark_aux()
        return [n.name for n in self._topo_nodes()
                if n.is_var() and not n._aux_mark]

    def list_auxiliary_states(self):
        self._mark_aux()
        return [n.name for n in self._topo_nodes()
                if n.is_var() and n._aux_mark]

    def list_inputs(self):
        """Every variable, arguments and auxiliary states, in graph
        order."""
        return [n.name for n in self._topo_nodes() if n.is_var()]

    def attr(self, key):
        """The attribute ``key`` of the first output's node, as a string,
        else None."""
        v = self._outputs[0][0].attrs.get("__attrs__", {}).get(key)
        return None if v is None else str(v)

    def attr_dict(self):
        """{variable or node name: {attribute: str}} of the attributes set
        on variables (``__lr_mult__``, ``__wd_mult__``, ``__init__``...)."""
        ret = {}
        for n in self._topo_nodes():
            meta = n.attrs.get("__attrs__", {})
            if meta:
                ret[n.name] = {k: str(v) for k, v in meta.items()}
        return ret

    def list_outputs(self):
        outs = []
        for node, idx in self._outputs:
            if node.is_var():
                outs.append(node.name)
            elif node.num_outputs == 1:
                outs.append(node.name + "_output")
            else:
                outs.append(_output_name(node, idx) + "_output")
        return outs

    # -- shape inference ------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given argument
        shapes, by name or in ``list_arguments()`` order."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """``infer_shape`` that leaves None where a shape cannot be
        inferred instead of raising."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = dict(kwargs)
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = s
        shapes, out_shapes = _graph_infer(self, known, partial=partial)
        return ([shapes.get(n) for n in arg_names], out_shapes,
                [shapes.get(n) for n in self.list_auxiliary_states()])

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types): the given argument types, by
        name or in ``list_arguments()`` order, f32 for every other
        argument, output and auxiliary state (the JAX package's rule)."""
        arg_names = self.list_arguments()
        given = {n: t for n, t in zip(arg_names, args) if t is not None}
        given.update(kwargs)
        f32 = np.dtype(np.float32)
        return ([_np_type(given.get(n, f32)) for n in arg_names],
                [f32] * len(self._outputs),
                [f32] * len(self.list_auxiliary_states()))

    # -- serialization (reference JSON graph format) --------------------
    def tojson(self):
        nodes = self._topo_nodes()
        idmap = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": "null" if n.is_var() else n.op,
            "name": n.name,
            "attrs": _json_attrs(n.attrs),
            "inputs": [[idmap[id(src)], oi, 0] for (src, oi) in n.inputs],
        } for n in nodes]
        heads = [[idmap[id(node)], idx, 0] for node, idx in self._outputs]
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_var()]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10201]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def debug_str(self):
        """One line a node: ``Variable:<name>`` or ``Op:<op>, Name=<name>,
        Inputs=[...]``."""
        lines = []
        for n in self._topo_nodes():
            if n.is_var():
                lines.append("Variable:%s" % n.name)
            else:
                lines.append("Op:%s, Name=%s, Inputs=[%s]" % (
                    n.op, n.name, ", ".join(src.name for src, _ in n.inputs)))
        return "\n".join(lines)

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        return _sym_binary(self, other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _sym_binary(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _sym_binary(self, other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return _sym_binary(self, other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sym_binary(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _sym_binary(self, other, "broadcast_div", "_rdiv_scalar")

    def __pow__(self, other):
        return _sym_binary(self, other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return _sym_binary(self, other, "broadcast_power",
                           "_rpower_scalar")

    def __neg__(self):
        return create("negative", [self], {})

    def __eq__(self, other):
        return _sym_binary(self, other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return _sym_binary(self, other, "broadcast_not_equal",
                           "_not_equal_scalar")

    def __gt__(self, other):
        return _sym_binary(self, other, "broadcast_greater",
                           "_greater_scalar")

    def __ge__(self, other):
        return _sym_binary(self, other, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, other):
        return _sym_binary(self, other, "broadcast_lesser",
                           "_lesser_scalar")

    def __le__(self, other):
        return _sym_binary(self, other, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # -- tensor methods as ops -------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape", ())
        return create("Reshape", [self], {"shape": tuple(shape)})

    def astype(self, dtype):
        return create("Cast", [self], {"dtype": dtype})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return create("transpose", [self], {"axes": axes or None})

    def flatten(self):
        return create("Flatten", [self], {})

    def sum(self, axis=None, keepdims=False):
        return create("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return create("mean", [self], {"axis": axis, "keepdims": keepdims})

    def softmax(self, axis=-1):
        return create("softmax", [self], {"axis": axis})

    def slice_axis(self, axis, begin, end):
        return create("slice_axis", [self],
                      {"axis": axis, "begin": begin, "end": end})

    def expand_dims(self, axis):
        return create("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return create("squeeze", [self], {"axis": axis})

    # -- binding ---------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    shared_exec=None, **kwargs):
        from ..executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict,
                                    shared_exec=shared_exec, **kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, shared_exec=None):
        from ..executor import Executor
        return Executor.bind(self, ctx, args, args_grad=args_grad,
                             grad_req=grad_req, aux_states=aux_states)

    def eval(self, ctx=None, **kwargs):
        """Bind the given arrays on ``ctx`` and run one inference forward:
        the outputs. Without ``ctx``, the arrays' own context, else the
        enclosing ``with ctx:`` scope's, else ``gpu(0)``."""
        from ..context import gpu, scope_context
        if ctx is None:
            ctx = next((v.context for v in kwargs.values()
                        if hasattr(v, "context")), None)
        return self.bind(ctx or scope_context() or gpu(0), kwargs).forward()


def _output_name(node, idx):
    # multi-output ops name their outputs <name><index>, as the JAX package
    return "%s%d" % (node.name, idx)


def _sym_binary(lhs, rhs, op, scalar_op):
    """``lhs <op> rhs`` (the reversed scalar ops put the scalar first)."""
    if isinstance(rhs, Symbol):
        return create(op, [lhs, rhs], {})
    if isinstance(rhs, (int, float)):
        return create(scalar_op, [lhs], {"scalar": float(rhs)})
    raise TypeError("type %s not supported" % str(type(rhs)))


def _np_type(dtype):
    """A dtype spelling as numpy's, ``"bfloat16"`` kept as that string
    (numpy has no bf16)."""
    if str(dtype).endswith("bfloat16"):
        return "bfloat16"
    return dtype_np(dtype)


def _json_attrs(attrs):
    return {k: (v if isinstance(v, str) else json.dumps(v))
            for k, v in attrs.items() if k != "__attrs__"}


def _op_input_names(op_name, attrs):
    """Per-op input names, used to create missing weight/bias/state
    variables at compose time (``{name}_weight`` ...), as the reference
    does."""
    if op_name in ("FullyConnected", "Convolution", "Deconvolution"):
        return ["data", "weight"] + \
            ([] if attrs.get("no_bias", False) else ["bias"])
    if op_name in ("BatchNorm", "BatchNorm_v1"):
        return ["data", "gamma", "beta", "moving_mean", "moving_var"]
    if op_name in ("LayerNorm", "InstanceNorm"):
        return ["data", "gamma", "beta"]
    if op_name == "Embedding":
        return ["data", "weight"]
    if op_name == "RNN":
        names = ["data", "parameters", "state"]
        if attrs.get("mode") == "lstm":
            names.append("state_cell")
        return names
    if op_name == "LeakyReLU" and attrs.get("act_type") == "prelu":
        return ["data", "gamma"]
    if op_name in ("SoftmaxOutput", "Softmax", "LinearRegressionOutput",
                   "LogisticRegressionOutput", "MAERegressionOutput",
                   "SVMOutput"):
        return ["data", "label"]
    return None


def create(op_name, input_syms, attrs, name=None):
    """Create a Symbol applying ``op_name`` over input symbols."""
    name = NameManager.current().get(name, op_name.lower().lstrip("_"))
    attrs = dict(attrs)
    scope_attrs = AttrScope.current().get(None)
    if scope_attrs:
        attrs["__attrs__"] = dict(scope_attrs)
    inputs = []
    for s in input_syms:
        if not isinstance(s, Symbol):
            raise TypeError("inputs must be Symbols, got %s" % type(s))
        inputs.extend(s._outputs)
    arg_names = _op_input_names(op_name, attrs)
    if arg_names is not None:
        for missing in arg_names[len(inputs):]:
            inputs.append((_Node(None, "%s_%s" % (name, missing), {}, []), 0))
    node = _Node(op_name, name, dict(attrs), inputs)
    # only the visible outputs compose (BatchNorm's mean/var are hidden)
    n_vis = get_op(op_name).n_visible(node.attrs)
    return Symbol([(node, i) for i in range(n_vis)])


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, **kwargs):
    """Create a free variable (reference symbol.var)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    meta = dict(AttrScope.current().get(attr))
    if shape is not None:
        meta["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        meta["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        meta["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        meta["__dtype__"] = "bfloat16" if str(dtype).endswith("bfloat16") \
            else str(np.dtype(dtype))
    if init is not None:
        meta["__init__"] = init.dumps() if hasattr(init, "dumps") \
            else str(init)
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            meta[k] = str(v)
    return Symbol([(_Node(None, name, {"__attrs__": meta}, []), 0)])


Variable = var


def Group(symbols):
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = {}
        for k, v in jn.get("attrs", {}).items():
            try:
                attrs[k] = json.loads(v)
            except (ValueError, TypeError):
                attrs[k] = v
        if jn["op"] == "null":
            node = _Node(None, jn["name"],
                         {"__attrs__": attrs} if attrs else {}, [])
        else:
            node = _Node(jn["op"], jn["name"], attrs,
                         [(nodes[i], oi) for i, oi, _ in jn["inputs"]])
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, _ in data["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# graph shape inference over meta tensors
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(tuple(int(d) for d in shape), dtype=dtype,
                       device="meta")


def _graph_infer(sym, known_shapes, type_dict=None, partial=False):
    """Returns (arg shapes by name, output shapes). With ``partial`` a
    shape that cannot be inferred is None (and so is every output that
    depends on it) instead of an error."""
    type_dict = type_dict or {}
    var_shape = {}
    var_dtype = {}
    metas = {}   # id(node) -> list of meta tensors (None = unknown)
    for n in sym._topo_nodes():
        if n.is_var():
            meta = n.attrs.get("__attrs__", {})
            s = known_shapes.get(n.name)
            if s is None and "__shape__" in meta:
                s = tuple(int(x) for x in meta["__shape__"].strip("()")
                          .split(",") if x.strip())
                if 0 in s:      # a deferred Gluon shape: still unknown
                    s = None
            dt = type_dict.get(n.name) or meta.get("__dtype__")
            var_dtype[n.name] = torch_dtype(dt) if dt else None
            var_shape[n.name] = tuple(s) if s is not None else None
            metas[id(n)] = [None if s is None else
                            _meta(s, var_dtype[n.name] or torch.float32)]
            continue
        op = get_op(n.op)
        ins = [metas[id(src)][oi] for src, oi in n.inputs]
        unknown = [i for i, m in enumerate(ins) if m is None]
        if unknown:
            try:
                filled = _infer.fill_param_shapes(
                    n.op, _clean_attrs(n.attrs),
                    [None if m is None else tuple(m.shape) for m in ins])
            except MXNetError:
                if not partial:
                    raise
                filled = [None] * len(ins)
            ref = next((m.dtype for m in ins if m is not None),
                       torch.float32)
            for i in unknown:
                src, _ = n.inputs[i]
                if filled[i] is None or not src.is_var():
                    if partial:
                        continue
                    raise MXNetError("cannot infer shape of input %d to %s"
                                     % (i, n.name))
                var_shape[src.name] = tuple(filled[i])
                ins[i] = _meta(filled[i], var_dtype[src.name] or ref)
                metas[id(src)] = [ins[i]]
        if any(m is None for m in ins):
            metas[id(n)] = [None] * n.num_outputs
            continue
        metas[id(n)] = list(op.fcompute(_eval_params(n, op), *ins))
    out_shapes = [None if metas[id(node)][idx] is None
                  else tuple(metas[id(node)][idx].shape)
                  for node, idx in sym._outputs]
    return var_shape, out_shapes


def _clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if k != "__attrs__"}


def _eval_params(node, op):
    params = _clean_attrs(node.attrs)
    if op.need_train_flag:
        params["_is_train"] = False
    if op.need_rng:
        params["_generator"] = None
    return params
