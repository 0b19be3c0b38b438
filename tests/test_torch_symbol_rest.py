"""The public methods of the port's ``Symbol`` against the JAX package's,
on the CPU (ROADMAP C.12).

The same graph is built in both packages: ``infer_shape_partial``,
``infer_type``, ``list_inputs``, ``get_children``, ``attr`` and
``debug_str`` give the same answers; the tensor methods (``reshape``,
``astype``, ``transpose``, ``flatten``, ``sum``, ``mean``, ``softmax``,
``slice_axis``, ``expand_dims``, ``squeeze``), ``**`` and the six
comparisons build the same ops (``2 ** x``, which the JAX ``Symbol``
refuses, is held to numpy), and ``eval`` through both packages gives
the same values (rtol 1e-6: one op each, f32). A comparison gives a
Symbol, and a Symbol still hashes. The JAX side runs with
``MXNET_XLA_STATS=0`` (its executor's compile tracker fails under JAX
0.9).
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _fc(pkg):
    x = pkg.sym.var("x")
    return pkg.sym.FullyConnected(x, num_hidden=4, name="fc")


def _bn_net(pkg):
    x = pkg.sym.var("x", attr={"mood": "calm"})
    c = pkg.sym.Convolution(x, num_filter=3, kernel=(3, 3), name="conv")
    b = pkg.sym.BatchNorm(c, name="bn")
    flat = pkg.sym.Flatten(b, name="flat")
    return pkg.sym.FullyConnected(flat, num_hidden=5, name="out")


def _nodes(sym):
    """The graph's nodes as (op, name, attrs, inputs) from its JSON."""
    return [(n["op"], n["name"], n["attrs"], n["inputs"])
            for n in json.loads(sym.tojson())["nodes"]]


def test_graph_queries_match():
    j, t = _bn_net(mx), _bn_net(mxt)
    assert t.list_inputs() == j.list_inputs()
    assert t.debug_str() == j.debug_str()
    assert t.get_children().list_outputs() == j.get_children().list_outputs()
    assert mxt.sym.var("v").get_children() is None
    assert mx.sym.var("v").get_children() is None
    jx, tx = mx.sym.var("x", attr={"mood": "calm"}), \
        mxt.sym.var("x", attr={"mood": "calm"})
    assert tx.attr("mood") == jx.attr("mood") == "calm"
    assert tx.attr("none") is jx.attr("none") is None
    assert [s.name for s in t] == [s.name for s in j]


def test_infer_shape_partial_matches():
    j, t = _bn_net(mx), _bn_net(mxt)
    # nothing known: every shape unknown, no error
    assert t.infer_shape_partial() == j.infer_shape_partial()
    got = t.infer_shape_partial(x=(2, 1, 6, 6))
    want = j.infer_shape_partial(x=(2, 1, 6, 6))
    assert got == want
    assert got[1] == [(2, 5)]
    with pytest.raises(mxt.MXNetError):
        t.infer_shape()


@pytest.mark.parametrize("args,kwargs", [
    ((), {}), ((np.float16,), {}), ((), {"x": np.float64}),
    ((None, np.int32), {})])
def test_infer_type_matches(args, kwargs):
    got = _fc(mxt).infer_type(*args, **kwargs)
    want = _fc(mx).infer_type(*args, **kwargs)
    assert got == want


def _method_cases(pkg):
    x = pkg.sym.var("x")
    y = pkg.sym.var("y")
    return {
        "reshape": x.reshape((3, 8)), "reshape_args": x.reshape(4, 6),
        "astype": x.astype("float16"), "transpose": x.transpose((1, 0, 2)),
        "transpose_none": x.transpose(), "flatten": x.flatten(),
        "sum": x.sum(axis=1), "sum_all": x.sum(), "mean": x.mean(
            axis=2, keepdims=True),
        "softmax": x.softmax(axis=1), "slice_axis": x.slice_axis(2, 1, 3),
        "expand_dims": x.expand_dims(1), "squeeze": x.expand_dims(0)
        .squeeze(axis=0), "pow": x ** 2.0, "pow_sym": x ** y,
        "eq": x == y, "ne": x != y, "lt": x < y,
        "le": x <= y, "gt": x > y, "ge": x >= y, "eq_scalar": x == 0.5,
        "ne_scalar": x != 0.5, "lt_scalar": x < 0.0, "le_scalar": x <= 0.0,
        "gt_scalar": x > 0.0, "ge_scalar": x >= 0.0}


_JAX_CASES = sorted(_method_cases(mx))


@pytest.mark.parametrize("case", _JAX_CASES)
def test_methods_build_the_same_ops_and_eval_the_same(case):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 4).astype(np.float32)
    y = rs.randn(2, 3, 4).astype(np.float32)
    y[0, 0] = x[0, 0]                       # an equal pair for == and <=
    t, j = _method_cases(mxt)[case], _method_cases(mx)[case]
    assert isinstance(t, mxt.sym.Symbol)
    want_ops = [op for op, *_ in _nodes(j)]
    assert [op for op, *_ in _nodes(t)] == want_ops
    feed = {"x": x, "y": y}
    names = t.list_arguments()
    assert names == j.list_arguments()
    if case in ("pow", "pow_sym"):
        feed["x"] = np.abs(x) + 0.5
    got = t.eval(ctx=mxt.cpu(), **{n: mxt.nd.array(feed[n], ctx=mxt.cpu())
                                   for n in names})
    want = j.eval(ctx=mx.cpu(), **{n: mx.nd.array(feed[n]) for n in names})
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(),
                               rtol=RTOL, atol=ATOL)


def test_rpow_builds_rpower_scalar():
    """``2 ** x``: the port builds ``_rpower_scalar`` (the JAX ``Symbol``
    has no ``__rpow__`` and raises), held to numpy."""
    x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    s = 2.0 ** mxt.sym.var("x")
    assert [op for op, *_ in _nodes(s)] == ["null", "_rpower_scalar"]
    got = s.eval(x=mxt.nd.array(x, ctx=mxt.cpu()))[0].asnumpy()
    np.testing.assert_allclose(got, 2.0 ** x, rtol=RTOL, atol=ATOL)
    with pytest.raises(TypeError):
        2.0 ** mx.sym.var("x")


def test_eval_takes_its_arrays_context_and_groups():
    """Without ``ctx``, ``eval`` binds on its arrays' context (the card's
    counterpart is ``test_torch_cuda.py``)."""
    x = mxt.sym.var("x")
    g = mxt.sym.Group([x * 2.0, x + 1.0])
    out = g.eval(x=mxt.nd.array([1.0, 2.0], ctx=mxt.cpu()))
    assert [o.context for o in out] == [mxt.cpu(), mxt.cpu()]
    np.testing.assert_array_equal(out[0].asnumpy(), [2.0, 4.0])
    np.testing.assert_array_equal(out[1].asnumpy(), [2.0, 3.0])


def test_comparison_is_a_symbol_and_symbols_hash():
    x, y = mxt.sym.var("x"), mxt.sym.var("y")
    assert isinstance(x == y, mxt.sym.Symbol)
    assert isinstance(x != x, mxt.sym.Symbol)
    seen = {x: 1, y: 2}
    assert seen[x] == 1 and seen[y] == 2 and len({x, y, x}) == 2
    with pytest.raises(TypeError):
        x == "x"      # noqa: B015 - the JAX package raises alike
    with pytest.raises(TypeError):
        mx.sym.var("x") == "x"      # noqa: B015
