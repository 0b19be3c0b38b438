"""Executor: a Symbol bound to arrays on one device.

Counterpart of `mxnet_tpu/executor.py`: ``simple_bind`` (with
``grad_req`` and ``shared_exec`` buffer sharing, the reference's
shared-buffer rebind for bucketing), ``forward``, ``backward``,
``forward_backward``, ``reshape`` and ``copy_params_from``. The JAX
package jits the whole graph into one XLA program and differentiates it
with ``jax.vjp``; the port runs the ops eagerly in topological order, so
there is no counterpart to `compiled.py` here and each op launches its
own kernels. A training forward (``is_train=True``) records the graph
with ``torch.autograd`` from leaf copies of the arguments that take a
gradient, and the following ``backward`` writes their gradients into
``grad_dict``; any other forward runs under ``torch.no_grad()``. The
graph-rewrite folds of the JAX executor, aux states, ``bind`` and the
monitor belong to later slices.
"""
from __future__ import annotations

import torch

from . import random as _random
from .base import MXNetError
from .ndarray.ndarray import NDArray, zeros as nd_zeros
from .ops.registry import get_op
from .symbol.symbol import Symbol, _graph_infer

__all__ = ["Executor"]

_GRAD_REQS = ("write", "add", "null")


def _build_eval(sym: Symbol, ctx):
    """eval_fn(arg_vals, generator, is_train) -> list of output tensors."""
    nodes = sym._topo_nodes()
    out_index = [(id(n), i) for n, i in sym._outputs]

    def eval_fn(arg_vals, generator, is_train):
        env = {}
        for n in nodes:
            if n.is_var():
                if n.name not in arg_vals:
                    raise MXNetError("unbound variable %s" % n.name)
                env[id(n)] = [arg_vals[n.name]]
                continue
            op = get_op(n.op)
            params = {k: v for k, v in n.attrs.items() if k != "__attrs__"}
            params["_ctx"] = ctx
            if op.need_train_flag:
                params["_is_train"] = is_train
            if op.need_rng:
                params["_generator"] = generator
            outs = op.fcompute(params, *[env[id(src)][oi]
                                         for src, oi in n.inputs])
            env[id(n)] = list(outs)
        return [env[nid][i] for nid, i in out_index]

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


class Executor:
    def __init__(self, symbol, ctx, arg_dict, grad_dict=None, grad_req=None):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device()
        self._arg_names = symbol.list_arguments()
        self._output_names = symbol.list_outputs()
        self.arg_dict = arg_dict            # name -> NDArray (shared)
        self.grad_dict = grad_dict or {}    # name -> NDArray
        self._grad_req = grad_req or {n: "null" for n in self._arg_names}
        self._grad_names = [n for n in self._arg_names
                            if self._grad_req.get(n, "null") != "null"]
        self._eval_fn = _build_eval(symbol, ctx)
        self._need_rng = any(get_op(n.op).need_rng
                             for n in symbol._topo_nodes() if not n.is_var())
        # one generator seed per forward, from a per-executor base that
        # `random.seed` fixes
        self._seed = _random.executor_seed()
        self._recorded = None   # (outputs, leaves) of a training forward
        self.outputs = []

    @staticmethod
    def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                    shared_exec=None, **kwargs):
        """Allocate every argument from the given shapes (zeros), and a
        gradient buffer for each argument whose ``grad_req`` is not
        ``null``; arguments (and gradients) of ``shared_exec`` with the
        same name and shape are shared, not copied."""
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
        return Executor(symbol, ctx, arg_dict, grad_dict, req)

    def reshape(self, **kwargs):
        """A new executor for new input shapes, sharing every array whose
        shape is unchanged (reference Executor::Reshape)."""
        return Executor.simple_bind(self._symbol, self._ctx,
                                    grad_req=self._grad_req,
                                    shared_exec=self, **kwargs)

    def _generator(self):
        if not self._need_rng:
            return None
        gen = torch.Generator(device=self._device)
        gen.manual_seed(self._seed)
        self._seed = (self._seed + 1) & ((1 << 63) - 1)
        return gen

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
        gen = self._generator()
        arg_vals = {n: a.data for n, a in self.arg_dict.items()}
        self._recorded = None
        if is_train and self._grad_names:
            leaves = {n: arg_vals[n].detach().requires_grad_(True)
                      for n in self._grad_names}
            arg_vals.update(leaves)
            with torch.enable_grad():
                outs = self._eval_fn(arg_vals, gen, True)
            self._recorded = (outs, leaves)
            outs = [o.detach() for o in outs]
        else:
            with torch.no_grad():
                outs = self._eval_fn(arg_vals, gen, bool(is_train))
        self.outputs = [NDArray(v, self._ctx) for v in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward into ``grad_dict``
        (``write`` replaces, ``add`` accumulates). A head without an
        ``out_grad`` takes ones, as in the reference (loss heads such as
        ``SoftmaxOutput`` ignore it). Without a training forward since the
        last backward, it runs one first."""
        if self._recorded is None:
            self.forward(is_train=True)
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

    def forward_backward(self, out_grads=None, **kwargs):
        """One training forward and its backward."""
        outs = self.forward(is_train=True, **kwargs)
        self.backward(out_grads=out_grads)
        return outs

    # -- views -----------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: NDArray or numpy}`` into the bound arguments.
        ``aux_params`` must be empty: the port has no aux states yet."""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name \"%s\" that is not in the "
                                 "arguments" % name)
        if aux_params and not allow_extra_params:
            raise ValueError("no auxiliary states in this graph: %s"
                             % sorted(aux_params))
