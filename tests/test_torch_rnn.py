"""`mx.rnn` and the ``RNN`` op of the port on the CPU, against the JAX
package.

Every test of `tests/test_rnn.py` but the ``gluon.contrib`` ones is a
parity case here: the same cells built in both packages give the same
argument names, outputs and output shapes, and, where the graph is
deterministic, the same outputs and gradients from the same numpy
inputs (forward rtol 1e-5, gradients rtol 1e-5, LSTM gradients 1e-4, the
reference's tolerance; atol 1e-6 both: f32 on both sides, in another
summation order). ``Dropout`` draws from each package's own generator,
so the graphs holding it (``DropoutCell``, ``ZoneoutCell``) are held in
predict mode, where it is the identity. The ``RNN`` op is held in every
mode, direction and layer count, and its LSTM against the JAX package's
Pallas ``fused_lstm`` run in interpret mode (`tests/test_rnn.py` forces
it the same way, by patching ``_fused_lstm_ok``): forward K1's function,
and through the executor's backward K2's and K3's. Weight packing,
``unfuse()``, ``BucketSentenceIter``'s batches under the same seeds,
the checkpoint helpers and the names of ``mx.rnn`` are held too. The JAX
package runs with ``MXNET_XLA_STATS=0`` (see `test_torch_module.py`).
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RTOL, ATOL, LSTM_GRAD_RTOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(autouse=True)
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


# ---------------------------------------------------------------------------
# cells built in both packages
# ---------------------------------------------------------------------------
def _stack(pkg, p):
    cell = pkg.rnn.SequentialRNNCell()
    cell.add(pkg.rnn.LSTMCell(6, prefix=p + "l0_"))
    cell.add(pkg.rnn.LSTMCell(6, prefix=p + "l1_"))
    return cell


def _bidirectional(pkg, p):
    return pkg.rnn.BidirectionalCell(pkg.rnn.LSTMCell(6, prefix=p + "bl_"),
                                     pkg.rnn.GRUCell(6, prefix=p + "br_"))


def _dropout_stack(pkg, p):
    cell = pkg.rnn.SequentialRNNCell()
    cell.add(pkg.rnn.RNNCell(6, prefix=p + "d0_"))
    cell.add(pkg.rnn.DropoutCell(0.5))
    return cell


#: every cell kind, built with a prefix ``p`` that namespaces its names
CELLS = {
    "rnn_tanh": lambda pkg, p: pkg.rnn.RNNCell(6, prefix=p + "rnn_"),
    "rnn_relu": lambda pkg, p: pkg.rnn.RNNCell(6, activation="relu",
                                               prefix=p + "rr_"),
    "lstm": lambda pkg, p: pkg.rnn.LSTMCell(6, prefix=p + "lstm_",
                                            forget_bias=0.5),
    "gru": lambda pkg, p: pkg.rnn.GRUCell(6, prefix=p + "gru_"),
    "stacked": _stack,
    "bidirectional": _bidirectional,
    "residual": lambda pkg, p: pkg.rnn.ResidualCell(
        pkg.rnn.RNNCell(4, prefix=p + "res_")),
    "zoneout": lambda pkg, p: pkg.rnn.ZoneoutCell(
        pkg.rnn.RNNCell(6, prefix=p + "zo_"), 0.3, 0.3),
    "dropout": _dropout_stack,
    "unfused_bidirectional": lambda pkg, p: pkg.rnn.FusedRNNCell(
        3, num_layers=2, mode="lstm", bidirectional=True,
        prefix=p + "fb_").unfuse(),
}
#: cells whose graph draws (Dropout): held in predict mode
RANDOM = {"zoneout", "dropout"}
LSTM_CELLS = {"lstm", "stacked", "bidirectional", "unfused_bidirectional"}
T, B, I = 2, 2, 4


def _unroll(pkg, name, merge=None, layout="NTC", p=""):
    cell = CELLS[name](pkg, p)
    if merge is None:
        inputs = [pkg.sym.Variable("%st%d_data" % (p, i)) for i in range(T)]
    else:
        inputs = pkg.sym.Variable(p + "data")
    outputs, states = cell.unroll(T, inputs, layout=layout,
                                  merge_outputs=merge)
    outputs = pkg.sym.Group(outputs) if isinstance(outputs, list) \
        else outputs
    return cell, outputs, states


def _input_shapes(merge, layout="NTC", p=""):
    if merge is None:
        return {"%st%d_data" % (p, i): (B, I) for i in range(T)}
    return {p + "data": (B, T, I) if layout == "NTC" else (T, B, I)}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_graph_matches(name):
    """Names of parameters, arguments and outputs, the begin states'
    names and shapes, and the output shapes, as the JAX cells give them
    (`test_rnn.py`'s shape tests, every cell)."""
    graphs = {}
    for pkg in (mx, mxt):
        cell, out, _ = _unroll(pkg, name)
        _, shapes, _ = out.infer_shape(**_input_shapes(None))
        begin = cell.begin_state()
        graphs[pkg] = (sorted(cell.params._params), out.list_arguments(),
                       out.list_outputs(), [tuple(s) for s in shapes],
                       [b.name for b in begin],
                       [tuple(s) for s in pkg.sym.Group(begin)
                        .infer_shape()[1]],
                       cell.state_info)
    assert graphs[mxt] == graphs[mx]


def _run(pkg, sym, values, train, heads=None):
    """Outputs and (in training) the gradients of every argument, with
    the head gradients ``heads`` (numpy, one an output)."""
    shapes = {n: v.shape for n, v in values.items()}
    ex = sym.simple_bind(ctx=pkg.cpu(), grad_req="write" if train
                         else "null", **shapes)
    for n, v in values.items():
        ex.arg_dict[n][:] = v
    outs = [_np(o) for o in ex.forward(is_train=train)]
    if not train:
        return outs, {}
    if heads is None:
        rng = np.random.RandomState(7)
        heads = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    ex.backward(out_grads=[pkg.nd.array(h) for h in heads])
    return outs, {n: _np(g) for n, g in ex.grad_dict.items()
                  if g is not None}


def _assert_same(got, want, grads_rtol=RTOL):
    (out_t, grad_t), (out_j, grad_j) = got, want
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert sorted(grad_t) == sorted(grad_j)
    for n in grad_j:
        np.testing.assert_allclose(grad_t[n], grad_j[n], rtol=grads_rtol,
                                   atol=ATOL, err_msg=n)


def _jax_grouped(cases, build, train):
    """The JAX side of many cases in one executor (one compile): each
    case ``build(mx, key, p)`` -> (symbol, input shapes) is namespaced by
    its prefix ``p``; its arguments get seeded random values and its
    outputs seeded head gradients. Returns {key: (values, heads,
    (outputs, gradients))}, the case's own share of the run."""
    syms, shapes, spans = [], {}, []
    for k, key in enumerate(cases):
        sym, shp = build(mx, key, "c%d_" % k)
        n0 = sum(len(s.list_outputs()) for s in syms)
        syms.append(sym)
        shapes.update(shp)
        spans.append((n0, n0 + len(sym.list_outputs()), sym))
    group = mx.sym.Group(syms)
    arg_shapes, out_shapes, _ = group.infer_shape(**shapes)
    values, heads = {}, []
    for k, (_, _, sym) in enumerate(spans):
        rng = np.random.RandomState(100 + k)
        for n in sym.list_arguments():
            values[n] = (rng.randn(*arg_shapes[
                group.list_arguments().index(n)]) * 0.5).astype(np.float32)
    rng = np.random.RandomState(7)
    heads = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    outs, grads = _run(mx, group, values, train, heads)
    result = {}
    for key, (a, b, sym) in zip(cases, spans):
        names = sym.list_arguments()
        result[key] = ({n: values[n] for n in names}, heads[a:b],
                       (outs[a:b], {n: grads[n] for n in names
                                    if n in grads}))
    return result


_JAX = {}


def _jax_case(table, key):
    """The JAX result of ``key`` from its table's one grouped run."""
    if table not in _JAX:
        cases, build, train = TABLES[table]
        _JAX[table] = _jax_grouped(cases, build, train)
    return _JAX[table][key]


def _check_case(table, key, grads_rtol):
    cases, build, train = TABLES[table]
    values, heads, want = _jax_case(table, key)
    sym, _ = build(mxt, key, "c%d_" % cases.index(key))
    _assert_same(_run(mxt, sym, values, train, heads), want, grads_rtol)


def _build_cell(pkg, key, p):
    name, merge = key
    _, out, _ = _unroll(pkg, name, merge=merge, p=p)
    return out, _input_shapes(merge, p=p)


MODES = ["rnn_relu", "rnn_tanh", "lstm", "gru"]
FUSED = [(mode, bidir, layout) for mode in MODES for bidir in (False, True)
         for layout in ("NTC", "TNC")]


def _build_fused(pkg, key, p):
    """A one-layer ``FusedRNNCell`` with ``get_next_state``: its output
    and final states (two layers: ``_build_explicit``)."""
    mode, bidir, layout = key
    cell = pkg.rnn.FusedRNNCell(5, num_layers=1, mode=mode,
                                bidirectional=bidir, get_next_state=True,
                                prefix=p + "f_")
    out, states = cell.unroll(T, pkg.sym.Variable(p + "data"),
                              layout=layout, merge_outputs=True)
    return pkg.sym.Group([out] + states), _input_shapes(True, layout, p)


def _build_explicit(pkg, mode, p):
    """``sym.RNN`` with batch-B begin states as inputs (so their
    gradients too), 2 layers, bidirectional."""
    kw = {"state_cell": pkg.sym.Variable(p + "c0")} if mode == "lstm" \
        else {}
    sym = pkg.sym.RNN(data=pkg.sym.Variable(p + "data"),
                      parameters=pkg.sym.Variable(p + "w"),
                      state=pkg.sym.Variable(p + "h0"), state_size=5,
                      num_layers=2, bidirectional=True, mode=mode,
                      state_outputs=True, name=p + "rnn", **kw)
    n = mxt.ops.nn.rnn_param_size(2, I, 5, True, mode)
    shapes = {p + "data": (T, B, I), p + "w": (n,), p + "h0": (4, B, 5)}
    if mode == "lstm":
        shapes[p + "c0"] = (4, B, 5)
    return pkg.sym.Group(list(sym)), shapes


VALUE_CASES = [(name, merge) for name in sorted(CELLS)
               for merge in (None, True)]
TABLES = {
    "cells": ([c for c in VALUE_CASES if c[0] not in RANDOM], _build_cell,
              True),
    "random_cells": ([c for c in VALUE_CASES if c[0] in RANDOM],
                     _build_cell, False),
    "fused": (FUSED, _build_fused, True),
    "explicit": (MODES, _build_explicit, True),
}


@pytest.mark.parametrize("merge", [None, True], ids=["steps", "merged"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_values_match(name, merge):
    """Outputs and gradients of the unrolled cell from the same inputs
    (predict mode, outputs only, for the cells that hold Dropout)."""
    _check_case("random_cells" if name in RANDOM else "cells",
                (name, merge),
                LSTM_GRAD_RTOL if name in LSTM_CELLS else RTOL)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("mode", MODES)
def test_fused_cell_matches(mode, bidir, layout):
    """``FusedRNNCell`` over the ``RNN`` op with ``state_outputs``: the
    output and final states and every gradient (data, the
    flat parameters), each mode × direction × layout."""
    _check_case("fused", (mode, bidir, layout),
                LSTM_GRAD_RTOL if mode == "lstm" else RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_explicit_states(mode):
    """``sym.RNN`` with the begin states as inputs: outputs, final
    states, and the gradients of data, parameters and states."""
    _check_case("explicit", mode, LSTM_GRAD_RTOL if mode == "lstm" else RTOL)


def test_rnn_dropout_draws_only_in_training():
    """Inter-layer dropout at p = 0.5 over a 2-layer LSTM: the op asks
    for a generator only in training with p > 0 and more than one layer
    (so an inference call captures); in training the kept values are
    scaled by exactly 1/(1-p), the keep rate is within 4 sigma, and the
    same seed gives the same mask."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("RNN")
    base = {"mode": "lstm", "state_size": 8, "num_layers": 2, "p": 0.5}
    assert op.draws(dict(base, _is_train=True))
    assert not op.draws(dict(base, _is_train=False))
    assert not op.draws(dict(base, num_layers=1, _is_train=True))
    assert not op.draws(dict(base, p=0.0, _is_train=True))
    # the two-layer op against its layers run one by one, the first
    # layer's output masked from the same generator draw in between
    Hn, In = 8, 8
    rng = np.random.RandomState(5)
    layer = [{k: torch.tensor(rng.randn(*s).astype(np.float32) * 0.3)
              for k, s in (("wi", (4 * Hn, In)), ("wh", (4 * Hn, Hn)),
                           ("bi", (4 * Hn,)), ("bh", (4 * Hn,)))}
             for _ in range(2)]
    flat = torch.cat([layer[0]["wi"].reshape(-1), layer[0]["wh"].reshape(-1),
                      layer[1]["wi"].reshape(-1), layer[1]["wh"].reshape(-1),
                      layer[0]["bi"], layer[0]["bh"], layer[1]["bi"],
                      layer[1]["bh"]])
    x = torch.randn(40, 64, In)
    h0 = torch.zeros(2, 1, Hn)
    params = dict(base, _is_train=True, _ctx=mxt.cpu())

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return op.fcompute(dict(params, _generator=g), x, flat, h0, h0)[0]

    def one(data, lw):
        w = torch.cat([lw["wi"].reshape(-1), lw["wh"].reshape(-1), lw["bi"],
                       lw["bh"]])
        return op.fcompute(dict(base, num_layers=1, _is_train=True),
                           data, w, h0[:1], h0[:1])[0]

    y1 = one(x, layer[0])
    mask = torch.bernoulli(torch.full_like(y1, 0.5),
                           generator=torch.Generator().manual_seed(1))
    want = one(y1 * mask / 0.5, layer[1])
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(a, want, rtol=1e-6, atol=1e-7)
    keep = float(mask.mean())
    assert abs(keep - 0.5) < 4 * np.sqrt(0.25 / mask.numel())


def test_rnn_op_lstm_matches_pallas_interpret():
    """The port's LSTM layer (the plain versions of K1, K2 and K3 on the
    CPU) against the JAX package's Pallas ``fused_lstm`` in interpret
    mode: a bidirectional one-layer op, forward (K1's function) and, in
    training through each executor, every gradient (K2's and K3's)."""
    from mxnet_tpu.ops import nn as nn_ops
    Tn, Bn, In, Hn = 6, 4, 8, 16
    rng = np.random.RandomState(0)
    n = mx.ops.nn.rnn_param_size(1, In, Hn, True, "lstm")
    values = {"data": rng.randn(Tn, Bn, In).astype(np.float32),
              "w": (rng.randn(n) * 0.1).astype(np.float32),
              "h0": (rng.randn(2, Bn, Hn) * 0.5).astype(np.float32),
              "c0": (rng.randn(2, Bn, Hn) * 0.5).astype(np.float32)}

    def graph(pkg):
        return pkg.sym.Group(list(pkg.sym.RNN(
            data=pkg.sym.Variable("data"), parameters=pkg.sym.Variable("w"),
            state=pkg.sym.Variable("h0"), state_cell=pkg.sym.Variable("c0"),
            state_size=Hn, num_layers=1, bidirectional=True, mode="lstm",
            state_outputs=True, name="rnn")))

    saved = nn_ops._fused_lstm_ok
    calls = []

    def forced(*a, **k):
        calls.append(1)
        return True
    nn_ops._fused_lstm_ok = forced
    try:
        want_infer = _run(mx, graph(mx), values, train=False)
        want = _run(mx, graph(mx), values, train=True)
    finally:
        nn_ops._fused_lstm_ok = saved
    assert calls, "the JAX op never asked for the Pallas kernel"
    _assert_same(_run(mxt, graph(mxt), values, train=False), want_infer)
    _assert_same(_run(mxt, graph(mxt), values, train=True), want,
                 LSTM_GRAD_RTOL)


# ---------------------------------------------------------------------------
# weights: pack, unpack, unfuse, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,bidir,layers", [
    ("lstm", False, 1), ("lstm", True, 2), ("gru", True, 2),
    ("rnn_tanh", False, 2), ("rnn_relu", True, 1)])
def test_fused_matches_unfuse(mode, bidir, layers):
    """A FusedRNNCell and its ``unfuse()`` stack fed the unpacked
    weights give the same outputs (`test_rnn.py`'s fused/unfused
    check), in the port, and the unpacked arrays equal the JAX
    package's."""
    H, Tn = 4, 5
    x = np.random.RandomState(0).randn(B, Tn, I).astype(np.float32)
    n = mxt.ops.nn.rnn_param_size(layers, I, H, bidir, mode)
    flat = (np.random.RandomState(1).randn(n) * 0.3).astype(np.float32)
    outs, unpacked = {}, {}
    for pkg in (mx, mxt):
        fused = pkg.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                     bidirectional=bidir, prefix="f_")
        unpacked[pkg] = {k: _np(v) for k, v in fused.unpack_weights(
            {"f_parameters": pkg.nd.array(flat)}).items()}
    assert sorted(unpacked[mxt]) == sorted(unpacked[mx])
    for k, v in unpacked[mx].items():
        np.testing.assert_array_equal(unpacked[mxt][k], v)
    fused = mxt.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                 bidirectional=bidir, prefix="f_")
    data = mxt.sym.Variable("data")
    fo, _ = fused.unroll(Tn, data, layout="NTC", merge_outputs=True)
    outs["fused"] = _run(mxt, fo, {"data": x, "f_parameters": flat},
                         train=False)[0][0]
    stack = fused.unfuse()
    so, _ = stack.unroll(Tn, data, layout="NTC", merge_outputs=True)
    vals = dict(unpacked[mxt], data=x)
    vals = {k: v for k, v in vals.items() if k in so.list_arguments()}
    outs["unfused"] = _run(mxt, so, vals, train=False)[0][0]
    np.testing.assert_allclose(outs["fused"], outs["unfused"], rtol=1e-4,
                               atol=1e-5)


def test_pack_unpack_roundtrip():
    """`test_rnn.py`'s fused and per-gate round trips, both packages."""
    n = mxt.ops.nn.rnn_param_size(2, 5, 8, True, "gru")
    flat = np.random.RandomState(1).randn(n).astype(np.float32)
    rng = np.random.RandomState(2)
    gates = {"lstm_i2h_weight": rng.randn(16, 3), "lstm_i2h_bias":
             rng.randn(16), "lstm_h2h_weight": rng.randn(16, 4),
             "lstm_h2h_bias": rng.randn(16)}
    got = {}
    for pkg in (mx, mxt):
        cell = pkg.rnn.FusedRNNCell(8, num_layers=2, mode="gru",
                                    prefix="g_", bidirectional=True)
        un = cell.unpack_weights({"g_parameters": pkg.nd.array(flat)})
        assert "g_parameters" not in un
        assert un["g_l0_i2h_weight"].shape == (24, 5)
        re = cell.pack_weights(un)
        np.testing.assert_array_equal(_np(re["g_parameters"]), flat)
        lstm = pkg.rnn.LSTMCell(4, prefix="lstm_")
        args = {k: pkg.nd.array(v.astype(np.float32))
                for k, v in gates.items()}
        un2 = lstm.unpack_weights(dict(args))
        assert un2["lstm_i2h_f_weight"].shape == (4, 3)
        re2 = lstm.pack_weights(un2)
        for k in args:
            np.testing.assert_array_equal(_np(re2[k]), _np(args[k]))
        got[pkg] = ({k: _np(v) for k, v in un.items()},
                    {k: _np(v) for k, v in un2.items()})
    for a, b in zip(got[mxt], got[mx]):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_rnn_checkpoint_roundtrip(tmp_path):
    """``save_rnn_checkpoint`` writes per-gate weights, which the JAX
    package's ``load_rnn_checkpoint`` packs back, and the other way; and
    ``pack_weights`` over ``params_from_numpy`` packs the JAX file's
    arrays."""
    n = mxt.ops.nn.rnn_param_size(2, 6, 4, False, "lstm")
    flat = np.random.RandomState(3).randn(n).astype(np.float32)
    for src, dst in ((mxt, mx), (mx, mxt)):
        cell = src.rnn.FusedRNNCell(4, num_layers=2, prefix="lm_")
        sym, _ = cell.unroll(3, src.sym.Variable("data"),
                             merge_outputs=True)
        prefix = str(tmp_path / ("from_%s" % src.__name__))
        src.rnn.save_rnn_checkpoint(
            cell, prefix, 1, sym, {"lm_parameters": src.nd.array(flat)}, {})
        cell2 = dst.rnn.FusedRNNCell(4, num_layers=2, prefix="lm_")
        _, args, _ = dst.rnn.load_rnn_checkpoint(cell2, prefix, 1)
        np.testing.assert_array_equal(_np(args["lm_parameters"]), flat)
        raw = dst.nd.load("%s-0001.params" % prefix)
        assert "arg:lm_l1_h2h_weight" in raw
    _, saved, _ = mx.model.load_checkpoint(str(tmp_path / "from_mxnet_tpu"),
                                           1)
    cell = mxt.rnn.FusedRNNCell(4, num_layers=2, prefix="lm_")
    packed = cell.pack_weights(mxt.params_from_numpy(
        {k: v.asnumpy() for k, v in saved.items()}, mxt.cpu()))
    np.testing.assert_array_equal(packed["lm_parameters"].asnumpy(), flat)
    cb = mxt.rnn.do_rnn_checkpoint(cell, str(tmp_path / "cb"), period=2)
    cb(0, sym, {"lm_parameters": mxt.nd.array(flat)}, {})
    cb(1, sym, {"lm_parameters": mxt.nd.array(flat)}, {})
    assert (tmp_path / "cb-0002.params").exists()
    assert not (tmp_path / "cb-0001.params").exists()


# ---------------------------------------------------------------------------
# the iterator
# ---------------------------------------------------------------------------
def _batches(pkg, sentences, seed, **kw):
    random.seed(seed)
    np.random.seed(seed)
    it = pkg.rnn.BucketSentenceIter(sentences, **kw)
    out = []
    for epoch in range(2):
        for batch in it:
            out.append((batch.bucket_key, _np(batch.data[0]),
                        _np(batch.label[0]), batch.provide_data[0].shape,
                        batch.provide_label[0].shape))
        it.reset()
    return it, out


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_iter_same_batches(layout):
    """Under the same ``random`` and ``np.random`` seeds the two
    packages' iterators give the same batches in the same order, two
    epochs, with the same descriptions."""
    rng = np.random.RandomState(4)
    sentences = [list(rng.randint(1, 30, rng.randint(2, 12)))
                 for _ in range(90)]
    kw = dict(batch_size=4, buckets=[4, 8, 12], invalid_label=0,
              layout=layout)
    it_j, want = _batches(mx, sentences, 9, **kw)
    it_t, got = _batches(mxt, sentences, 9, **kw)
    assert it_t.default_bucket_key == it_j.default_bucket_key
    assert [tuple(d.shape) for d in it_t.provide_data] == \
        [tuple(d.shape) for d in it_j.provide_data]
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3:] == w[3:]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


def test_encode_sentences_and_bucket_iter():
    """`test_rnn.py`'s encoding and iterator checks, both packages."""
    sentences = [["a", "b", "c"], ["a", "c"], ["b", "c", "a"],
                 ["a", "b"], ["c"], ["a", "b", "c"]]
    enc = {pkg: pkg.rnn.encode_sentences(sentences, start_label=1)
           for pkg in (mx, mxt)}
    assert enc[mxt] == enc[mx]
    assert len(enc[mxt][1]) == 4
    seen = 0
    for batch in mxt.rnn.BucketSentenceIter(enc[mxt][0], batch_size=2,
                                            buckets=[2, 3],
                                            invalid_label=-1):
        seen += 1
        d, lb = _np(batch.data[0]), _np(batch.label[0])
        assert batch.data[0].shape == (2, batch.bucket_key)
        np.testing.assert_array_equal(lb[:, :-1], d[:, 1:])
    assert seen >= 2
    with pytest.raises(AssertionError):
        mxt.rnn.encode_sentences([["z"]], vocab={"a": 1})


def test_bucket_iter_empty_bucket():
    for pkg in (mx, mxt):
        it = pkg.rnn.BucketSentenceIter([[1, 2], [2, 1], [1, 2]],
                                        batch_size=2, buckets=[2, 5],
                                        invalid_label=-1)
        assert [b.bucket_key for b in it] == [2]


def test_rnn_unroll_is_deprecated():
    cell = mxt.rnn.LSTMCell(4, prefix="u_")
    with pytest.warns(DeprecationWarning):
        out, states = mxt.rnn.rnn_unroll(
            cell, 2, [mxt.sym.Variable("a"), mxt.sym.Variable("b")])
    assert len(out) == 2 and len(states) == 2


def test_fused_cell_cannot_step():
    cell = mxt.rnn.FusedRNNCell(4)
    with pytest.raises(NotImplementedError):
        cell(mxt.sym.Variable("x"), [])
    with pytest.raises(AssertionError):
        mxt.rnn.ZoneoutCell(cell, 0.1, 0.1)


def test_names_equal_jax_all():
    """``mx.rnn`` holds every name of the JAX package's ``__all__``s."""
    from mxnet_tpu.rnn import io as jio, rnn as jrnn, rnn_cell as jcell
    for mod in (jcell, jrnn, jio):
        for name in mod.__all__:
            assert hasattr(mxt.rnn, name), name
    import mxnet_tpu_torch.rnn.io as tio
    import mxnet_tpu_torch.rnn.rnn as trnn
    import mxnet_tpu_torch.rnn.rnn_cell as tcell
    assert (tcell.__all__, trnn.__all__, tio.__all__) == \
        (jcell.__all__, jrnn.__all__, jio.__all__)
    assert "BucketingModule" in mxt.mod.__all__
    assert isinstance(mxt.init.LSTMBias(0.5), mxt.init.Initializer)
