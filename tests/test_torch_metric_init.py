"""The port's metrics and initializers against the JAX package's.

Metrics: every metric of the JAX `metric.py` the port lacked
(``TopKAccuracy``, ``F1`` macro and micro, ``MAE``, ``MSE``, ``RMSE``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``CustomMetric`` and
``np``) takes the same labels and predictions over several updates in
both packages, and reads the same value (rtol 1e-6: both sum in numpy
on the host); ``create`` finds each under the JAX names and aliases and
takes a callable.

Initializers: ``Orthogonal``, ``MSRAPrelu``, ``Bilinear``, ``Mixed`` and
``Load`` draw from numpy's global generator in the same order in both
packages, so from one seed they fill the same values, bit for bit; and
they work as a Gluon net's and a ``Module``'s initializer.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def test_all_equals_the_jax_packages():
    assert mxt.metric.__all__ == mx.metric.__all__
    assert set(mxt.initializer.__all__) == \
        set(mx.initializer.__all__) | {"create"}
    for name in mx.initializer.__all__:
        assert hasattr(mxt.init, name), name


def _updates(kind, seed=0, n=3):
    """``n`` (labels, predictions) numpy pairs for a metric kind."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "class":
            pred = rng.rand(8, 5).astype(np.float32)
            out.append((rng.randint(0, 5, 8).astype(np.float32),
                        pred / pred.sum(1, keepdims=True)))
        elif kind == "binary":
            out.append((rng.randint(0, 2, 10).astype(np.float32),
                        rng.rand(10, 2).astype(np.float32)))
        else:
            lab = rng.randn(6).astype(np.float32)
            out.append((lab, (lab + 0.3 * rng.randn(6)).astype(np.float32)
                        .reshape(6, 1) if kind == "column" else
                        (lab + 0.3 * rng.randn(6)).astype(np.float32)))
    return out


def _mae(label, pred):
    return float(np.abs(label.ravel() - pred.ravel()).mean())


def _sum_count(label, pred):
    return float(np.abs(label.ravel() - pred.ravel()).sum()), label.size


METRICS = [
    ("TopKAccuracy", {"top_k": 2}, "class"),
    ("TopKAccuracy", {"top_k": 3}, "class"),
    ("F1", {}, "binary"),
    ("F1", {"average": "micro"}, "binary"),
    ("MAE", {}, "regression"),
    ("MAE", {}, "column"),
    ("MSE", {}, "regression"),
    ("RMSE", {}, "column"),
    ("NegativeLogLikelihood", {}, "class"),
    ("PearsonCorrelation", {}, "regression"),
    ("CustomMetric", {"feval": _mae}, "regression"),
    ("CustomMetric", {"feval": _sum_count, "name": "sc"}, "regression"),
    ("CustomMetric", {"feval": _mae, "allow_extra_outputs": True},
     "regression"),
]


def _value(pkg, cls, kwargs, kind):
    m = getattr(pkg.metric, cls)(**kwargs)
    for label, pred in _updates(kind):
        m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                 [pkg.nd.array(pred, ctx=pkg.cpu())])
    return m.get()


@pytest.mark.parametrize("cls,kwargs,kind", METRICS,
                         ids=["%s-%d" % (m[0], i) for i, m in
                              enumerate(METRICS)])
def test_metric_matches_jax(cls, kwargs, kind):
    (wn, wv), (gn, gv) = _value(mx, cls, kwargs, kind), \
        _value(mxt, cls, kwargs, kind)
    assert gn == wn
    np.testing.assert_allclose(gv, wv, rtol=1e-6)


def test_np_metric_and_create_by_name_and_callable():
    def acc(label, pred):
        return float((pred.argmax(1) == label).mean())
    for pkg in (mx, mxt):
        assert pkg.metric.np(acc).name == "acc"
        assert isinstance(pkg.metric.create(acc), pkg.metric.CustomMetric)
        for name, cls in (("top_k_accuracy", "TopKAccuracy"),
                          ("top_k_acc", "TopKAccuracy"), ("f1", "F1"),
                          ("mae", "MAE"), ("mse", "MSE"), ("rmse", "RMSE"),
                          ("nll_loss", "NegativeLogLikelihood"),
                          ("pearsonr", "PearsonCorrelation"),
                          ("pearsoncorrelation", "PearsonCorrelation")):
            kw = {"top_k": 2} if cls == "TopKAccuracy" else {}
            assert type(pkg.metric.create(name, **kw)).__name__ == cls
    got, want = [], []
    for pkg, out in ((mx, want), (mxt, got)):
        m = pkg.metric.create([pkg.metric.np(acc), "mae"])
        for label, pred in _updates("class"):
            m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                     [pkg.nd.array(pred, ctx=pkg.cpu())])
        out.append(m.get())
    assert got[0][0] == want[0][0]
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-6)


def test_top_k_of_one_raises_in_both():
    with pytest.raises(AssertionError):
        mx.metric.TopKAccuracy(top_k=1)
    with pytest.raises(ValueError):
        mxt.metric.TopKAccuracy(top_k=1)


INITS = [
    ("Orthogonal", {}, "fc_weight", (6, 4)),
    ("Orthogonal", {"scale": 0.5, "rand_type": "normal"}, "fc_weight",
     (3, 2, 2, 2)),
    ("MSRAPrelu", {}, "conv_weight", (4, 3, 3, 3)),
    ("MSRAPrelu", {"factor_type": "in", "slope": 0.1}, "fc_weight", (5, 7)),
    ("Bilinear", {}, "up_weight", (3, 2, 4, 4)),
    ("Bilinear", {}, "up_weight", (2, 1, 5, 3)),
]


@pytest.mark.parametrize("cls,kwargs,name,shape", INITS,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(INITS)])
def test_initializer_fills_the_same_values(cls, kwargs, name, shape):
    values = []
    for pkg in (mx, mxt):
        arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
        np.random.seed(7)
        getattr(pkg.init, cls)(**kwargs)(pkg.init.InitDesc(name), arr)
        values.append(arr.asnumpy())
    np.testing.assert_array_equal(values[1], values[0])
    assert mxt.init.MSRAPrelu(slope=0.1).dumps() == \
        mx.init.MSRAPrelu(slope=0.1).dumps()


def test_mixed_and_load():
    src = np.arange(12, dtype=np.float32).reshape(3, 4)
    values = []
    for pkg in (mx, mxt):
        np.random.seed(3)
        mixed = pkg.init.Mixed([".*bias", ".*"],
                               [pkg.init.Constant(0.5), pkg.init.Xavier()])
        load = pkg.init.Load({"arg:fc_weight": pkg.nd.array(src),
                              "aux:bn_moving_mean": np.ones(4, np.float32)},
                             default_init=mixed)
        got = {}
        for name, shape in (("fc_weight", (3, 4)), ("fc_bias", (3,)),
                            ("bn_moving_mean", (4,)), ("out_weight", (2, 3))):
            arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
            load(name, arr)
            got[name] = arr.asnumpy()
        values.append(got)
        with pytest.raises(pkg.base.MXNetError):
            load("fc_weight", pkg.nd.zeros((4, 3), ctx=pkg.cpu()))
        with pytest.raises(pkg.base.MXNetError):
            pkg.init.Load({})("x_weight", pkg.nd.zeros((2,), ctx=pkg.cpu()))
        with pytest.raises(ValueError):
            pkg.init.Mixed(["a_.*"], [pkg.init.Zero()])(
                "b_weight", pkg.nd.zeros((2,), ctx=pkg.cpu()))
        with pytest.raises(pkg.base.MXNetError):
            pkg.init.Mixed(["a", "b"], [pkg.init.Zero()])
    for name in values[0]:
        np.testing.assert_array_equal(values[1][name], values[0][name])
    np.testing.assert_array_equal(values[1]["fc_weight"], src)
    # the name dispatch sends a bias to zeros whatever the initializer
    np.testing.assert_array_equal(values[1]["fc_bias"], 0.0)
    np.testing.assert_array_equal(values[1]["bn_moving_mean"], 1.0)


def test_mixed_initializes_a_gluon_net_and_a_module():
    """``Mixed`` as a Gluon net's and a ``Module``'s initializer, from one
    seed in both packages."""
    got = []
    for pkg in (mx, mxt):
        np.random.seed(11)
        init = pkg.init.Mixed([".*dense0.*", ".*"],
                              [pkg.init.Orthogonal(), pkg.init.MSRAPrelu()])
        net = pkg.gluon.nn.HybridSequential(prefix="m_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(4, in_units=3),
                    pkg.gluon.nn.Dense(2, in_units=4))
        net.initialize(init, ctx=pkg.cpu())
        gluon = {n: p.data().asnumpy()
                 for n, p in net.collect_params().items()}
        data = pkg.sym.Variable("data")
        sym = pkg.sym.LinearRegressionOutput(
            pkg.sym.FullyConnected(data, num_hidden=3, name="fc"),
            name="lin")
        mod = pkg.mod.Module(sym, label_names=("lin_label",),
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", (2, 5))],
                 label_shapes=[("lin_label", (2, 3))])
        np.random.seed(12)
        mod.init_params(initializer=pkg.init.Mixed(
            [".*bias", ".*"], [pkg.init.One(), pkg.init.Orthogonal()]))
        module = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
        got.append((gluon, module))
    for want, have in zip(got[0], got[1]):
        assert sorted(want) == sorted(have)
        for name in want:
            np.testing.assert_array_equal(have[name], want[name], name)
