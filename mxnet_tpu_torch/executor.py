"""Executor: a Symbol bound to arrays on one device.

Counterpart of `mxnet_tpu/executor.py`: ``simple_bind`` (with
``grad_req``, ``type_dict`` and ``shared_exec`` buffer sharing, the
reference's shared-buffer rebind for bucketing), ``bind``, ``forward``,
``backward``, ``forward_backward``, ``reshape`` and ``copy_params_from``,
with auxiliary states (BatchNorm's moving statistics) in ``aux_dict``.
The JAX package jits the whole graph into one XLA program per signature
(site ``executor.forward``) and differentiates it with ``jax.vjp``. In
the port an inference forward (``is_train=False``, no monitor) goes
through one `compiled.CompiledProgram` at the same site: on the card one
captured CUDA graph per signature, replayed with one ``cudaGraphLaunch``;
on the CPU the same cache and counters, run eagerly. The bound argument
and auxiliary tensors are the program's in-place arguments, so a replay
reads them where they lie and needs no input copy, and an executor that
``simple_bind(shared_exec=)`` or ``reshape`` makes over the same symbol
shares its program (one signature a shape, one graph pool for all). A
graph that would hold an op drawing random numbers, or one running on the
host (``Custom``, ``CTCLoss``), is not captured (`compiled.note_host_op`)
and runs eagerly, counted as ``uncaptured``. A training forward
(``is_train=True``) runs the ops eagerly in topological order: it records
the graph with ``torch.autograd`` from leaf copies of the arguments that
take a gradient, writes the new aux values back in place, and the
following ``backward`` writes the gradients into ``grad_dict``. A sampled
step of `module.Module` sets ``_hold`` (a `module._Holds`) for one
training forward and backward: the forward calls it after each node with
the node's outputs and the gradient copies call it after each gradient,
so that the step's device time is read in segments.

Two graph passes of the JAX executor run at bind, on by default with the
same switches, so both packages compute the same graph: the conv-bias ->
BatchNorm fold (``MXNET_FOLD_CONV_BIAS_BN=0`` skips it) and the relu ->
max-pool fold (``MXNET_FOLD_RELU_POOL=0``).

``set_monitor_callback`` installs a monitor (`monitor.Monitor`): every
forward then runs eagerly and calls it on each node's output
(``<node>_output``, or ``<node>_output<i>`` for a node of several
outputs) and, with
``monitor_all``, on each variable, as the JAX package's monitored
evaluation does. The graph then runs without the two folds, so that
each node's reported output is the node's own, as in the JAX package.
With the profiler's aggregate mode on, ``forward`` and
``forward_backward`` are timed into its table as ``_executor_forward``
and ``_executor_forward_backward``.
"""
from __future__ import annotations

import os
import time

import torch

from . import compiled
from . import random as _random
from .base import MXNetError
from .ndarray.ndarray import NDArray, zeros as nd_zeros
from .ops.registry import get_op
from .symbol.symbol import Symbol, _graph_infer

__all__ = ["Executor"]

_GRAD_REQS = ("write", "add", "null")


def _truthy(v):
    return v in (True, 1) or str(v).lower() in ("true", "1")


def _consumer_map(sym: Symbol, nodes):
    """(id(node), out_idx) -> list of consuming nodes (None = graph
    output)."""
    consumers = {}
    for n in nodes:
        for src, oi in n.inputs:
            consumers.setdefault((id(src), oi), []).append(n)
    for node, i in sym._outputs:
        consumers.setdefault((id(node), i), []).append(None)
    return consumers


def _plan_conv_bias_bn_fold(sym: Symbol, nodes):
    """Elide a conv bias that feeds straight into a BatchNorm over the
    same channel axis (`mxnet_tpu/executor.py:_plan_conv_bias_bn_fold`).

    BatchNorm's mean subtraction cancels a per-channel offset exactly, so
    the bias moves to the BatchNorm (``_fold_bias``), which keeps the
    moving mean in the x + b domain; the bias's gradient is then zero, as
    it is in real arithmetic. Returns {id(node): action}; the Symbol is
    not changed. Skips BatchNorms with ``use_global_stats``."""
    if os.environ.get("MXNET_FOLD_CONV_BIAS_BN", "1") == "0":
        return {}
    consumers = _consumer_map(sym, nodes)
    folds = {}
    for n in nodes:
        if n.op not in ("BatchNorm", "BatchNorm_v1") or not n.inputs:
            continue
        if _truthy(n.attrs.get("use_global_stats", False)):
            continue
        conv, oi = n.inputs[0]
        if conv.is_var() or conv.op != "Convolution" or oi != 0 \
                or id(conv) in folds:
            continue
        attrs = conv.attrs
        if _truthy(attrs.get("no_bias", False)) or len(conv.inputs) < 3:
            continue
        kernel = tuple(attrs.get("kernel") or ())
        if not kernel:
            continue
        rank = len(kernel) + 2
        spec = "DHW"[3 - len(kernel):]
        layout = attrs.get("layout") or ("NC" + spec)
        if layout in ("None", "NC" + spec):
            ch_axis = 1
        elif layout == "N" + spec + "C":
            ch_axis = rank - 1
        else:
            continue
        if int(n.attrs.get("axis", 1)) % rank != ch_axis:
            continue
        if len(consumers.get((id(conv), 0), [])) != 1:
            continue
        bias_src, bias_oi = conv.inputs[2]
        folds[id(conv)] = ("drop_bias",)
        folds[id(n)] = ("fold_bias", bias_src, bias_oi)
    return folds


def _plan_relu_pool_fold(sym: Symbol, nodes, folds):
    """Fold a relu into the max-Pooling that is its only consumer
    (`mxnet_tpu/executor.py:_plan_relu_pool_fold`): ``maxpool(relu(x)) ==
    max(maxpool(x), 0)``, and the gradients agree up to ties. Only the
    ``valid`` convention: a ``full`` window can cover padding alone."""
    if os.environ.get("MXNET_FOLD_RELU_POOL", "1") == "0":
        return
    consumers = _consumer_map(sym, nodes)
    for n in nodes:
        if n.op != "Pooling" or id(n) in folds or not n.inputs:
            continue
        if n.attrs.get("pool_type", "max") != "max" \
                or n.attrs.get("pooling_convention", "valid") != "valid":
            continue
        act, oi = n.inputs[0]
        if act.is_var() or act.op != "Activation" or oi != 0 \
                or id(act) in folds or act.attrs.get("act_type") != "relu":
            continue
        if len(consumers.get((id(act), 0), [])) != 1:
            continue
        folds[id(act)] = ("bypass",)
        folds[id(n)] = ("fold_relu",)


def _build_eval(sym: Symbol, ctx, fold=True):
    """eval_fn(arg_vals, aux_vals, generator, is_train, monitor=None) ->
    (list of output tensors, {aux name: new value}); ``monitor`` is a
    ``(callback, monitor_all)`` pair. ``fold=False`` leaves out the graph
    passes."""
    nodes = sym._topo_nodes()
    sym._mark_aux()
    out_index = [(id(n), i) for n, i in sym._outputs]
    folds = {}
    if fold:
        folds = _plan_conv_bias_bn_fold(sym, nodes)
        _plan_relu_pool_fold(sym, nodes, folds)

    def eval_fn(arg_vals, aux_vals, generator, is_train, monitor=None,
                hold=None):
        env = {}
        aux_updates = {}
        for n in nodes:
            if n.is_var():
                val = arg_vals.get(n.name, aux_vals.get(n.name))
                if val is None:
                    raise MXNetError("unbound variable %s" % n.name)
                env[id(n)] = [val]
                if monitor is not None and monitor[1]:
                    monitor[0](n.name, NDArray(val.detach(), ctx))
                continue
            op = get_op(n.op)
            params = {k: v for k, v in n.attrs.items() if k != "__attrs__"}
            params["_ctx"] = ctx
            if op.need_train_flag:
                params["_is_train"] = is_train
            if op.need_rng:
                params["_generator"] = generator
                if op.draws(params):
                    # a graph would replay the captured draws
                    compiled.note_host_op(n.op)
            fold = folds.get(id(n))
            if fold is not None:
                if fold[0] == "bypass":
                    src, oi = n.inputs[0]
                    env[id(n)] = [env[id(src)][oi]]
                    continue
                if fold[0] == "drop_bias":
                    params["no_bias"] = True
                elif fold[0] == "fold_bias":
                    params["_fold_bias"] = env[id(fold[1])][fold[2]]
                elif fold[0] == "fold_relu":
                    params["_fold_relu"] = True
            outs = op.fcompute(params, *[env[id(src)][oi]
                                         for src, oi in n.inputs])
            n_out = op.n_out(params)
            for ai, new in zip(op.mutate_aux, outs[n_out:]):
                src, _ = n.inputs[ai]
                if src.is_var():
                    aux_updates[src.name] = new
            env[id(n)] = list(outs[:n_out])
            if monitor is not None:
                for i, o in enumerate(env[id(n)]):
                    monitor[0]("%s_output%d" % (n.name, i) if n_out > 1
                               else n.name + "_output",
                               NDArray(o.detach(), ctx))
            if hold is not None:
                hold.node(env[id(n)])
        return [env[nid][i] for nid, i in out_index], aux_updates

    return eval_fn


def _norm_req(grad_req, arg_names):
    if isinstance(grad_req, str):
        req = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        req = dict(zip(arg_names, grad_req))
    elif isinstance(grad_req, dict):
        req = {n: "null" for n in arg_names}
        req.update(grad_req)
    else:
        raise MXNetError("invalid grad_req %r" % (grad_req,))
    bad = {r for r in req.values() if r not in _GRAD_REQS}
    if bad:
        raise MXNetError("grad_req must be one of %s, got %s"
                         % (_GRAD_REQS, sorted(bad)))
    return req


def _draws(sym: Symbol, ctx, is_train):
    """Whether a forward of ``sym`` (training or not) calls an op that
    draws random numbers."""
    for n in sym._topo_nodes():
        if n.is_var():
            continue
        op = get_op(n.op)
        if not op.need_rng:
            continue
        params = {k: v for k, v in n.attrs.items() if k != "__attrs__"}
        params["_ctx"] = ctx
        if op.need_train_flag:
            params["_is_train"] = is_train
        if op.draws(params):
            return True
    return False


def _inference_program(symbol, ctx, eval_fn):
    """The compiled inference forward of ``symbol`` on ``ctx``:
    ``program(arg tensors, aux tensors, seed)`` -> output tensors, the
    tensors in ``list_arguments`` / ``list_auxiliary_states`` order and
    read in place; ``seed`` seeds the forward's generator (None: no op of
    the graph draws in inference, and a capture must not make one)."""
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    device = ctx.torch_device()

    def forward(args, auxs, seed):
        gen = None
        if seed is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
        with torch.no_grad():
            outs, _ = eval_fn(dict(zip(arg_names, args)),
                              dict(zip(aux_names, auxs)), gen, False)
        return outs

    # a lineage token of its own: the id() of a collected symbol is
    # reused by later objects
    return compiled.CompiledProgram(
        forward, "executor.forward", inplace_argnums=(0, 1),
        key_argnums=(2,), lineage=object(),
        arg_names={0: arg_names, 1: aux_names}, timed=False)


class Executor:
    def __init__(self, symbol, ctx, arg_dict, grad_dict=None, grad_req=None,
                 aux_dict=None, program=None):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device()
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self.arg_dict = arg_dict            # name -> NDArray (shared)
        self.grad_dict = grad_dict or {}    # name -> NDArray
        self.aux_dict = aux_dict or {}      # name -> NDArray (shared)
        missing = [n for n in self._aux_names if n not in self.aux_dict]
        if missing:
            raise MXNetError("unbound auxiliary states %s" % missing)
        self._type_dict = {}     # simple_bind's, kept for reshape
        self._grad_req = grad_req or {n: "null" for n in self._arg_names}
        self._grad_names = [n for n in self._arg_names
                            if self._grad_req.get(n, "null") != "null"]
        self._eval_fn = _build_eval(symbol, ctx)
        self._program = program if program is not None else \
            _inference_program(symbol, ctx, self._eval_fn)
        self._need_rng = any(get_op(n.op).need_rng
                             for n in symbol._topo_nodes() if not n.is_var())
        self._infer_draws = _draws(symbol, ctx, False)
        # one generator seed per forward, from a per-executor base that
        # `random.seed` fixes
        self._seed = _random.executor_seed(ctx)
        self._recorded = None   # (outputs, leaves) of a training forward
        self._monitor = None    # (callback, monitor_all)
        self._hold = None       # a sampled step's module._Holds
        self.outputs = []

    @staticmethod
    def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                    shared_exec=None, **kwargs):
        """Allocate every argument and auxiliary state from the given
        shapes (zeros; ``type_dict`` names dtypes, f32 by default, so the
        moving statistics stay f32 under bf16 parameters), and a gradient
        buffer for each argument whose ``grad_req`` is not ``null``;
        arrays of ``shared_exec`` with the same name and shape are shared,
        not copied, and so is its inference program when it is bound over
        the same symbol on the same device."""
        arg_shapes, _ = _graph_infer(symbol, kwargs, type_dict=type_dict)
        type_dict = type_dict or {}
        req = _norm_req(grad_req, symbol.list_arguments())
        arg_dict, grad_dict = {}, {}
        for name in symbol.list_arguments():
            shape = arg_shapes.get(name)
            if shape is None:
                raise MXNetError("cannot infer shape of argument %s" % name)
            shared = shared_exec is not None \
                and name in shared_exec.arg_dict \
                and shared_exec.arg_dict[name].shape == tuple(shape)
            if shared:
                arg_dict[name] = shared_exec.arg_dict[name]
            else:
                arg_dict[name] = nd_zeros(shape, ctx=ctx,
                                          dtype=type_dict.get(name))
            if req[name] == "null":
                continue
            if shared and name in shared_exec.grad_dict:
                grad_dict[name] = shared_exec.grad_dict[name]
            else:
                grad_dict[name] = nd_zeros(shape, ctx=ctx,
                                           dtype=type_dict.get(name))
        aux_dict = {}
        for name in symbol.list_auxiliary_states():
            shape = tuple(arg_shapes[name])
            if shared_exec is not None and name in shared_exec.aux_dict \
                    and shared_exec.aux_dict[name].shape == shape:
                aux_dict[name] = shared_exec.aux_dict[name]
            else:
                aux_dict[name] = nd_zeros(shape, ctx=ctx,
                                          dtype=type_dict.get(name))
        program = None
        if shared_exec is not None and shared_exec._symbol is symbol \
                and shared_exec._ctx == ctx:
            program = shared_exec._program
        ex = Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict,
                      program=program)
        ex._type_dict = dict(type_dict)
        return ex

    @staticmethod
    def bind(symbol, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind given arrays (lists in ``list_arguments`` /
        ``list_auxiliary_states`` order, or dicts by name); without
        ``args_grad`` nothing takes a gradient."""
        arg_names = symbol.list_arguments()
        arg_dict = _to_dict(args, arg_names, "args")
        grad_dict = _to_dict(args_grad, arg_names, "args_grad") \
            if args_grad else {}
        aux_dict = _to_dict(aux_states, symbol.list_auxiliary_states(),
                            "aux_states") if aux_states else {}
        req = _norm_req(grad_req if args_grad else "null", arg_names)
        for name, r in req.items():
            if r != "null" and name not in grad_dict:
                req[name] = "null"
        return Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict)

    def reshape(self, **kwargs):
        """A new executor for new input shapes, sharing every array whose
        shape is unchanged (reference Executor::Reshape)."""
        return Executor.simple_bind(self._symbol, self._ctx,
                                    grad_req=self._grad_req,
                                    type_dict=self._type_dict,
                                    shared_exec=self, **kwargs)

    def _next_seed(self):
        """The seed of this forward's generator, or None when no op of
        the graph takes one."""
        if not self._need_rng:
            return None
        seed = self._seed
        self._seed = (self._seed + 1) & ((1 << 63) - 1)
        return seed

    def _generator(self):
        seed = self._next_seed()
        if seed is None:
            return None
        gen = torch.Generator(device=self._device)
        gen.manual_seed(seed)
        return gen

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on every node's output of each
        forward (and on every variable with ``monitor_all``); the graph
        then runs without its folds (see the module docstring)."""
        self._monitor = (callback, monitor_all)
        self._eval_fn = _build_eval(self._symbol, self._ctx, fold=False)

    def forward(self, is_train=False, **kwargs):
        """Run the graph; a training forward also writes the new values of
        the auxiliary states (BatchNorm's moving statistics) in place."""
        from . import profiler
        t0 = time.perf_counter()
        outs = self._forward(is_train, **kwargs)
        if profiler.aggregate_enabled() and self._monitor is None:
            profiler.finish_timed("_executor_forward", t0, outs)
        return outs

    def _forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
        self._recorded = None
        if not is_train and self._monitor is None:
            seed = self._next_seed()    # the sequence steps every forward
            outs = self._program([a.data for a in self.arg_arrays],
                                 [a.data for a in self.aux_arrays],
                                 seed if self._infer_draws else None)
            self.outputs = [NDArray(v, self._ctx) for v in outs]
            return self.outputs
        gen = self._generator()
        arg_vals = {n: a.data for n, a in self.arg_dict.items()}
        aux_vals = {n: a.data for n, a in self.aux_dict.items()}
        if is_train and self._grad_names:
            leaves = {n: arg_vals[n].detach().requires_grad_(True)
                      for n in self._grad_names}
            arg_vals.update(leaves)
            with torch.enable_grad():
                outs, aux_up = self._eval_fn(arg_vals, aux_vals, gen, True,
                                             self._monitor, self._hold)
            self._recorded = (outs, leaves)
            outs = [o.detach() for o in outs]
        else:
            with torch.no_grad():
                outs, aux_up = self._eval_fn(arg_vals, aux_vals, gen,
                                             bool(is_train), self._monitor,
                                             self._hold)
        if is_train:
            with torch.no_grad():
                for name, val in aux_up.items():
                    if val is not aux_vals[name]:
                        aux_vals[name].copy_(val)
        self.outputs = [NDArray(v, self._ctx) for v in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward into ``grad_dict``
        (``write`` replaces, ``add`` accumulates). A head without an
        ``out_grad`` takes ones, as in the reference (loss heads such as
        ``SoftmaxOutput`` ignore it). Without a training forward since the
        last backward, it runs one first."""
        if self._recorded is None:
            self._forward(is_train=True)
        if self._recorded is None:
            return      # no argument takes a gradient
        outs, leaves = self._recorded
        self._recorded = None
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        out_grads = list(out_grads or [])
        heads, cots = [], []
        for k, o in enumerate(outs):
            if not o.requires_grad:
                continue
            g = out_grads[k] if k < len(out_grads) else None
            heads.append(o)
            cots.append(torch.ones_like(o) if g is None else
                        (g.data if isinstance(g, NDArray) else g).to(o))
        names = list(leaves)
        grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                    grad_outputs=cots, allow_unused=True) \
            if heads else [None] * len(names)
        with torch.no_grad():
            for name, g in zip(names, grads):
                dst = self.grad_dict[name].data
                if self._grad_req[name] == "add":
                    if g is not None:
                        dst.add_(g.to(dst.dtype))
                elif g is None:
                    dst.zero_()
                else:
                    dst.copy_(g)
                if self._hold is not None:
                    self._hold.tick()

    def forward_backward(self, out_grads=None, **kwargs):
        """One training forward and its backward."""
        from . import profiler
        t0 = time.perf_counter()
        outs = self._forward(is_train=True, **kwargs)
        self.backward(out_grads=out_grads)
        if profiler.aggregate_enabled():
            profiler.finish_timed("_executor_forward_backward", t0,
                                  [outs, list(self.grad_dict.values())])
        return outs

    # -- views -----------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        """``{output name: NDArray}`` of the last forward."""
        return dict(zip(self._output_names, self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: NDArray or numpy}`` into the bound arguments and
        auxiliary states (cast to their dtypes)."""
        for src, dst, what in ((arg_params, self.arg_dict, "arguments"),
                               (aux_params or {}, self.aux_dict,
                                "auxiliary states")):
            for name, array in src.items():
                if name in dst:
                    dst[name][:] = array
                elif not allow_extra_params:
                    raise ValueError("Find name \"%s\" that is not in the "
                                     "%s" % (name, what))


def _to_dict(arrays, names, what):
    if isinstance(arrays, dict):
        return dict(arrays)
    if len(arrays) != len(names):
        raise MXNetError("Length of %s does not match the number of names"
                         % what)
    return dict(zip(names, arrays))
