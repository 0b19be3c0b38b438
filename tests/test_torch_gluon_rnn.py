"""`gluon.rnn` of the port on the CPU, against the JAX package.

Each layer or cell is built in both packages under one prefix (so the
parameter names match), the JAX net's initial weights are carried into
the port's by name (``params_to_numpy`` then ``set_block_params``), and
the outputs, the final states, the input gradient and every parameter
gradient of ``sum(out * r + out ** 2)`` (``r`` fixed draws) are held to
rtol 1e-5, the gradients of an LSTM to rtol 1e-4 (the reference's
tolerance); outputs at atol 1e-6, gradients at 1e-6 times their largest
magnitude: f32 on both sides, in another summation order.
The fused layers (``RNN``, ``LSTM``, ``GRU``) run in each mode, both
directions and both layouts (every combination of the op itself is in
`test_torch_rnn.py`), two layers, with and without explicit begin
states, eager and hybridized; the cells step and unroll. ``Dropout``
draws from each package's own generator, so ``DropoutCell`` and
``ZoneoutCell`` are held outside training, where it is the identity.
The JAX side of each table runs as one executor: every case's block is
a child of one hybridized block (children eager inside it, since the
JAX package's hybridized call refuses a cell's list of states), built
with its input sizes given, recorded once. Its eager calls would
compile op by op, most of this file's time. The port's side runs each
case on its own, eager with deferred input sizes unless the case says
otherwise. The JAX package runs with ``MXNET_XLA_STATS=0`` (see
`test_torch_module.py`).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RTOL, ATOL, LSTM_GRAD_RTOL = 1e-5, 1e-6, 1e-4
T, B, I, H = 3, 3, 5, 6


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _loss(pkg, outs):
    total = None
    for k, out in enumerate(outs):
        r = np.random.RandomState(k + 1).randn(*out.shape).astype(np.float32)
        term = (out * pkg.nd.array(r, ctx=pkg.cpu()) + out * out).sum()
        total = term if total is None else total + term
    return total


def _grads(net):
    return {n: p.grad().asnumpy()
            for n, p in sorted(net.collect_params().items())
            if p.grad_req != "null"}


def _run(net, pkg, x, call, train=True):
    """The outputs of ``call(net, pkg, x_nd)`` and, with ``train``, the
    input and parameter gradients of ``_loss`` over them."""
    a = pkg.nd.array(x, ctx=pkg.cpu())
    if not train:
        return [o.asnumpy() for o in _flat(call(net, pkg, a))], None, {}
    a.attach_grad()
    with pkg.autograd.record():
        outs = _flat(call(net, pkg, a))
        loss = _loss(pkg, outs)
    loss.backward()
    return [o.asnumpy() for o in outs], a.grad.asnumpy(), _grads(net)


def _close(got, want, rtol, name=""):
    """Elementwise within ``rtol``, and within ``ATOL`` times the
    largest magnitude of ``want`` (a gradient summed over T·B products
    of unit size cancels to small values in another order)."""
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))),
        err_msg=name)


class _JaxGroup(mx.gluon.HybridBlock):
    """The JAX blocks of one table as children, called in order on one
    input each; the outputs flattened, ``counts`` outputs a child."""

    def __init__(self, kids, calls):
        super().__init__(prefix="group_")
        self._calls, self.counts = calls, []
        for kid in kids:
            self.register_child(kid)

    def hybrid_forward(self, F, *xs):
        self.counts, outs = [], []
        for kid, call, x in zip(self._children.values(), self._calls, xs):
            got = _flat(call(kid, mx, x))
            self.counts.append(len(got))
            outs += got
        return tuple(outs)


_JAX = {}


def _reference(table, key):
    """The JAX result of ``table[key]``: its initial weights, outputs,
    input gradient and parameter gradients, from its table's one
    recorded run."""
    if table not in _JAX:
        cases = TABLES[table]
        with mx.cpu():
            kids = [build(mx, _prefix(k), True)
                    for k, (build, _, _) in cases.items()]
            group = _JaxGroup(kids, [call for _, _, call in cases.values()])
            group.initialize(mx.init.Xavier())
        group.hybridize()
        for kid in kids:
            kid.hybridize(False)
        weights = [mxt.params_to_numpy({n: p.data() for n, p in
                                        kid.collect_params().items()})
                   for kid in kids]
        xs = [mx.nd.array(x, ctx=mx.cpu()) for _, x, _ in cases.values()]
        for a in xs:
            a.attach_grad()
        with mx.autograd.record():
            outs = group(*xs)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            parts, loss = [], None
            for n in group.counts:
                parts.append(outs[:n])
                outs = outs[n:]
                term = _loss(mx, parts[-1])
                loss = term if loss is None else loss + term
        loss.backward()
        _JAX[table] = {
            k: (w, [o.asnumpy() for o in part], a.grad.asnumpy(), _grads(kid))
            for k, w, part, a, kid in zip(cases, weights, parts, xs, kids)}
    return _JAX[table][key]


def _prefix(key):
    return "c_%s_" % "_".join(str(k) for k in key)


def _check(table, key, hybridize=False, grads_rtol=RTOL):
    """The port's ``table[key]`` (deferred input sizes) against its JAX
    reference, from the same initial weights. Returns the port's net."""
    build, x, call = TABLES[table][key]
    weights, want_outs, want_dx, want_grads = _reference(table, key)
    with mxt.cpu():
        net = build(mxt, _prefix(key), False)
        net.initialize(mxt.init.Xavier())
    with mxt.autograd.pause():      # finish deferred shapes
        call(net, mxt, mxt.nd.array(x, ctx=mxt.cpu()))
    assert sorted(net.collect_params().keys()) == sorted(weights)
    mxt.set_block_params(net, weights)
    if hybridize:
        net.hybridize()
    outs, dx, grads = _run(net, mxt, x, call)
    assert len(outs) == len(want_outs)
    for a, b in zip(outs, want_outs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    _close(dx, want_dx, grads_rtol, "input")
    assert sorted(grads) == sorted(want_grads)
    for name in want_grads:
        _close(grads[name], want_grads[name], grads_rtol, name)
    return net


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LAYERS = {
    "rnn_relu": lambda pkg, **kw: pkg.gluon.rnn.RNN(H, activation="relu",
                                                    **kw),
    "rnn_tanh": lambda pkg, **kw: pkg.gluon.rnn.RNN(H, activation="tanh",
                                                    **kw),
    "lstm": lambda pkg, **kw: pkg.gluon.rnn.LSTM(H, **kw),
    "gru": lambda pkg, **kw: pkg.gluon.rnn.GRU(H, **kw),
}


def _layer_x(layout):
    return _x(*((T, B, I) if layout == "TNC" else (B, T, I)))


def _layer(mode, bidir, layout):
    """A two-layer fused layer; the port's with a deferred input size."""
    def build(pkg, prefix, sized):
        return LAYERS[mode](pkg, num_layers=2, layout=layout,
                            bidirectional=bidir, prefix=prefix,
                            input_size=I if sized else 0)
    return build, _layer_x(layout), lambda net, pkg, a: net(a)


def _with_states(net, pkg, a):
    batch = a.shape[1] if net._layout == "TNC" else a.shape[0]
    rng = np.random.RandomState(3)
    states = [pkg.nd.array(rng.randn(*s.shape).astype(np.float32) * 0.5,
                           ctx=pkg.cpu())
              for s in net.begin_state(batch, ctx=pkg.cpu())]
    return net(a, states)


def _stated(mode):
    def build(pkg, prefix, sized):
        return LAYERS[mode](pkg, num_layers=2, bidirectional=True,
                            input_size=I, prefix=prefix)
    return build, _layer_x("TNC"), _with_states


def _lm(mode):
    """Embedding -> two-layer layer -> Dense, as the Gluon LM (NTC)."""
    def build(pkg, prefix, sized):
        net = pkg.gluon.nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(pkg.gluon.nn.Embedding(20, I),
                    LAYERS[mode](pkg, num_layers=2, layout="NTC",
                                 input_size=I if sized else 0),
                    pkg.gluon.nn.Dense(20, flatten=False,
                                       in_units=H if sized else 0))
        return net
    x = np.random.RandomState(0).randint(0, 20, (B, T)).astype(np.float32)
    return build, x, lambda net, pkg, a: net(a)


LAYER_CASES = [("rnn_relu", False, "TNC"), ("rnn_tanh", True, "NTC"),
               ("lstm", True, "TNC"), ("lstm", False, "NTC"),
               ("gru", True, "NTC"), ("gru", False, "TNC")]


@pytest.mark.parametrize("mode,bidir,layout", LAYER_CASES)
def test_layer_matches(mode, bidir, layout):
    """A two-layer fused layer, deferred input size, no begin states
    (every mode × direction × layout of the op itself:
    `test_torch_rnn.py`)."""
    _check("layers", (mode, bidir, layout),
           grads_rtol=LSTM_GRAD_RTOL if mode == "lstm" else RTOL)


@pytest.mark.parametrize("mode,hybridize", [
    ("lstm", False), ("rnn_tanh", False), ("lstm", "port")])
def test_layer_with_states(mode, hybridize):
    """Explicit begin states: the output and the final states; the port's
    layer also hybridized, taking and returning a list of NDArrays (the
    JAX package's hybridized call refuses a list input, so its layer
    runs eagerly inside the table's executor)."""
    _check("layers", ("states", mode), hybridize=bool(hybridize),
           grads_rtol=LSTM_GRAD_RTOL if mode == "lstm" else RTOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_hybridized_layer(mode):
    """A hybridized Embedding -> layer -> Dense net (the Gluon LM's
    shape, `chip_smoke.py` phase 24), recorded and then outside
    ``record()`` (the call that a CUDA graph captures on the card)."""
    net = _check("layers", ("lm", mode), hybridize=True,
                 grads_rtol=LSTM_GRAD_RTOL if mode == "lstm" else RTOL)
    _, x, _ = TABLES["layers"][("lm", mode)]
    before = mxt.compiled.compile_counts()
    out = net(mxt.nd.array(x, ctx=mxt.cpu())).asnumpy()
    np.testing.assert_allclose(out, _reference("layers", ("lm", mode))[1][0],
                               rtol=RTOL, atol=ATOL)
    counts = mxt.compiled.compile_counts()
    assert counts["compiles"] - before["compiles"] == 1
    assert counts["uncaptured"] == before["uncaptured"]


def test_layer_begin_state_and_names():
    """Parameter names and shapes, ``state_info``, ``begin_state``'s
    names and shapes, and ``repr``, as the JAX layers give them."""
    seen = {}
    for pkg in (mx, mxt):
        rows = []
        for mode in sorted(LAYERS):
            with pkg.cpu():
                net = LAYERS[mode](pkg, num_layers=2, bidirectional=True,
                                   input_size=I, prefix="n_%s_" % mode)
                net.initialize()
            params = {k: v.shape for k, v in net.collect_params().items()}
            states = net.begin_state(B, ctx=pkg.cpu())
            rows.append((params, net.state_info(B),
                         [s.shape for s in states], repr(net)))
        seen[pkg] = rows
    assert seen[mxt] == seen[mx]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def _bi(pkg, prefix, n):
    return pkg.gluon.rnn.BidirectionalCell(
        pkg.gluon.rnn.LSTMCell(H, input_size=n, prefix=prefix + "l_"),
        pkg.gluon.rnn.GRUCell(H, input_size=n, prefix=prefix + "r_"))


def _seq(pkg, prefix, n):
    cell = pkg.gluon.rnn.SequentialRNNCell(prefix=prefix)
    with cell.name_scope():
        cell.add(pkg.gluon.rnn.LSTMCell(H, input_size=n))
        cell.add(pkg.gluon.rnn.GRUCell(H, input_size=n and H))
    return cell


def _seq_dropout(pkg, prefix, n):
    cell = pkg.gluon.rnn.SequentialRNNCell(prefix=prefix)
    with cell.name_scope():
        cell.add(pkg.gluon.rnn.RNNCell(H, input_size=n))
        cell.add(pkg.gluon.rnn.DropoutCell(0.5))
    return cell


# name -> cell(pkg, prefix, input size or 0 for deferred)
CELLS = {
    "rnn": lambda pkg, p, n: pkg.gluon.rnn.RNNCell(H, input_size=n,
                                                   prefix=p),
    "rnn_relu": lambda pkg, p, n: pkg.gluon.rnn.RNNCell(
        H, activation="relu", input_size=n, prefix=p),
    "lstm": lambda pkg, p, n: pkg.gluon.rnn.LSTMCell(H, input_size=n,
                                                     prefix=p),
    "gru": lambda pkg, p, n: pkg.gluon.rnn.GRUCell(H, input_size=n,
                                                   prefix=p),
    "sequential": _seq,
    "bidirectional": _bi,
    "residual": lambda pkg, p, n: pkg.gluon.rnn.ResidualCell(
        pkg.gluon.rnn.GRUCell(I, input_size=n, prefix=p)),
    "zoneout": lambda pkg, p, n: pkg.gluon.rnn.ZoneoutCell(
        pkg.gluon.rnn.RNNCell(H, input_size=n, prefix=p), 0.3, 0.3),
    "dropout": _seq_dropout,
}
RANDOM = {"zoneout", "dropout"}
LSTM_CELLS = {"lstm", "sequential", "bidirectional"}


def _unroll(merge, layout="NTC", valid=None):
    def call(cell, pkg, a):
        outs, states = cell.unroll(
            T, a, layout=layout, merge_outputs=merge,
            valid_length=None if valid is None else pkg.nd.array(
                valid, ctx=pkg.cpu()))
        return [outs, states]
    return call


def _cell(name, x, call):
    def build(pkg, prefix, sized):
        return CELLS[name](pkg, prefix, I if sized else 0)
    return build, x, call


UNROLLED = [(name, True) for name in sorted(CELLS)] + [
    (name, False) for name in ("bidirectional", "residual", "sequential")]


@pytest.mark.parametrize("name,merge", UNROLLED)
def test_cell_unroll_matches(name, merge):
    """``unroll`` over an NTC batch with the cell's own begin states:
    outputs, final states and gradients (outside training, outputs
    only, for the cells that hold Dropout, each in both packages on its
    own)."""
    if name not in RANDOM:
        _check("cells", ("unroll", name, merge),
               grads_rtol=LSTM_GRAD_RTOL if name in LSTM_CELLS else RTOL)
        return
    build, x, call = _cell(name, _x(B, T, I), _unroll(merge))
    nets = []
    for pkg in (mx, mxt):
        with pkg.cpu():
            net = build(pkg, "c_", False)
            net.initialize(pkg.init.Xavier())
        with pkg.autograd.pause():      # finish deferred shapes
            call(net, pkg, pkg.nd.array(x, ctx=pkg.cpu()))
        nets.append(net)
    mxt.set_block_params(nets[1], mxt.params_to_numpy(
        {k: v.data() for k, v in nets[0].collect_params().items()}))
    want, got = (_run(net, pkg, x, call, train=False)[0]
                 for pkg, net in zip((mx, mxt), nets))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _step(cell, pkg, a):
    states = cell.begin_state(batch_size=a.shape[0], ctx=pkg.cpu())
    out, states = cell(a, states)
    out2, states = cell(out * 0.5 if out.shape[1] == I else a, states)
    return [out, out2, states]


@pytest.mark.parametrize("name", ["rnn", "lstm", "gru", "sequential"])
def test_cell_step_matches(name):
    """Two steps called one by one, from ``begin_state``."""
    _check("cells", ("step", name),
           grads_rtol=LSTM_GRAD_RTOL if name in LSTM_CELLS else RTOL)


def test_cell_unroll_tnc_and_valid_length():
    """A TNC unroll, and ``valid_length`` masking (``SequenceMask``)."""
    _check("cells", ("tnc", "lstm"), grads_rtol=LSTM_GRAD_RTOL)
    _check("cells", ("valid", "gru"))


VALID = np.array([3, 1, 2], dtype=np.float32)
# table -> {case key: (build(pkg, prefix, sized), x, call(net, pkg, a))}
TABLES = {
    "layers": dict(
        [(c, _layer(*c)) for c in LAYER_CASES]
        + [(("states", m), _stated(m)) for m in ("lstm", "rnn_tanh")]
        + [(("lm", m), _lm(m)) for m in ("lstm", "gru")]),
    "cells": dict(
        [(("unroll", n, m), _cell(n, _x(B, T, I), _unroll(m)))
         for n, m in UNROLLED if n not in RANDOM]
        + [(("step", n), _cell(n, _x(B, I), _step))
           for n in ("rnn", "lstm", "gru", "sequential")]
        + [(("tnc", "lstm"), _cell("lstm", _x(T, B, I),
                                   _unroll(True, "TNC"))),
           (("valid", "gru"), _cell("gru", _x(B, T, I),
                                    _unroll(True, valid=VALID)))]),
}


def test_cell_names_and_states():
    """Parameter names, ``state_info`` and the begin states of every
    cell, as the JAX cells give them; a modified cell cannot be called."""
    seen = {}
    for pkg in (mx, mxt):
        rows = []
        for name in sorted(CELLS):
            cell = CELLS[name](pkg, "c_", 0)
            states = cell.begin_state(batch_size=B, ctx=pkg.cpu())
            rows.append((sorted(cell.collect_params().keys()),
                         cell.state_info(B), [s.shape for s in states]))
        seen[pkg] = rows
    assert seen[mxt] == seen[mx]
    base = mxt.gluon.rnn.LSTMCell(H)
    mxt.gluon.rnn.ZoneoutCell(base, 0.1, 0.1)
    with pytest.raises(AssertionError):
        base.begin_state(batch_size=B)


def test_names_equal_jax_all():
    from mxnet_tpu.gluon.rnn import rnn_cell as jcell, rnn_layer as jlayer
    from mxnet_tpu_torch.gluon.rnn import rnn_cell as tcell, \
        rnn_layer as tlayer
    assert (tcell.__all__, tlayer.__all__) == (jcell.__all__,
                                               jlayer.__all__)
    for name in jcell.__all__ + jlayer.__all__:
        assert hasattr(mxt.gluon.rnn, name), name
