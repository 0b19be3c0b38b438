"""The rest of ``callback``, ``FeedForward``, ``AttrScope`` and the
top-level names of the port, against the JAX package, on the CPU.

The callbacks run in both packages on the same module or parameters:
the checkpoint callbacks write the same files (the ``.params`` files
byte for byte, the symbol JSON equal as data) at the same epochs, the
loggers the same lines. ``FeedForward`` fits a small MLP 2 epochs from
weights carried into both packages (the same shuffle under one numpy
seed, SGD in f32): parameters and predictions at rtol 1e-5, atol 1e-6
(f32 sums in another order). Symbols built under nested ``AttrScope``s
have the same ``attr_dict()`` and the same JSON. The JAX executors run
with ``MXNET_XLA_STATS=0``.
"""
import json
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _mlp(pkg):
    data = pkg.sym.var("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(
        data, num_hidden=8, name="fc1"), act_type="relu", name="relu1")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        h, num_hidden=3, name="fc2"), name="softmax")


def _params():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.randn(8, 4).astype("f") * 0.5,
            "fc1_bias": np.zeros(8, "f"),
            "fc2_weight": rng.randn(3, 8).astype("f") * 0.5,
            "fc2_bias": np.zeros(3, "f")}


def _module(pkg):
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind([("data", (6, 4))], [("softmax_label", (6,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in _params().items()})
    return mod


def _files(tmp, sub):
    d = os.path.join(tmp, sub)
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _compare_dirs(tmp):
    assert _files(tmp, "jax") == _files(tmp, "torch") != []
    for name in _files(tmp, "jax"):
        a = os.path.join(tmp, "jax", name)
        b = os.path.join(tmp, "torch", name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_module_checkpoint(tmp_path):
    for pkg, sub in ((mx, "jax"), (mxt, "torch")):
        os.makedirs(str(tmp_path / sub))
        cb = pkg.callback.module_checkpoint(_module(pkg),
                                            str(tmp_path / sub / "mlp"),
                                            period=2)
        for epoch in range(5):
            cb(epoch)
    _compare_dirs(str(tmp_path))
    assert _files(str(tmp_path), "torch") == [
        "mlp-0002.params", "mlp-0004.params", "mlp-symbol.json"]


def test_do_checkpoint(tmp_path):
    for pkg, sub in ((mx, "jax"), (mxt, "torch")):
        os.makedirs(str(tmp_path / sub))
        cb = pkg.callback.do_checkpoint(str(tmp_path / sub / "net"), 3)
        arg = {k: pkg.nd.array(v, ctx=pkg.cpu())
               for k, v in _params().items()}
        for epoch in range(6):
            cb(epoch, _mlp(pkg), arg, {})
    _compare_dirs(str(tmp_path))
    sym, arg, aux = mxt.model.load_checkpoint(str(tmp_path / "torch" /
                                                  "net"), 6)
    assert sorted(arg) == sorted(_params()) and aux == {}


def _metric(pkg):
    m = pkg.metric.Accuracy()
    m.update([pkg.nd.array(np.array([0, 1, 1, 2], "f"), ctx=pkg.cpu())],
             [pkg.nd.array(np.eye(3, dtype="f")[[0, 1, 2, 2]],
                           ctx=pkg.cpu())])
    return m


def _lines(caplog, pkg, callback, nbatches, epoch=1):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for n in nbatches:
            callback(pkg.model.BatchEndParam(epoch=epoch, nbatch=n,
                                             eval_metric=_metric(pkg),
                                             locals=None))
    return [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("make,nbatches", [
    (lambda pkg: pkg.callback.log_train_metric(2), [1, 2, 3, 4]),
    (lambda pkg: pkg.callback.log_train_metric(3, auto_reset=True),
     [3, 6]),
    (lambda pkg: pkg.callback.ProgressBar(7, length=20), [1, 4, 7]),
    (lambda pkg: pkg.callback.LogValidationMetricsCallback(), [0]),
], ids=["log_train_metric", "auto_reset", "ProgressBar", "validation"])
def test_logging_callbacks(caplog, make, nbatches):
    want = _lines(caplog, mx, make(mx), nbatches)
    got = _lines(caplog, mxt, make(mxt), nbatches)
    assert got == want and got


def test_callback_names():
    assert mxt.callback.__all__ == [n for n in mx.callback.__all__
                                    if n != "elastic_checkpoint"]


def _feedforward(pkg, x, y, epochs):
    arg = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in _params().items()}
    model = pkg.FeedForward(_mlp(pkg), ctx=pkg.cpu(), num_epoch=epochs,
                            optimizer="sgd", numpy_batch_size=5,
                            arg_params=arg, aux_params={},
                            optimizer_params=(("learning_rate", 0.1),))
    np.random.seed(3)
    model.fit(x, y)
    return model


def test_feedforward_fit_and_predict():
    rng = np.random.RandomState(1)
    x = rng.randn(20, 4).astype("f")
    y = rng.randint(0, 3, 20).astype("f")
    want = _feedforward(mx, x, y, 2)
    got = _feedforward(mxt, x, y, 2)
    assert sorted(got.arg_params) == sorted(want.arg_params)
    for k in want.arg_params:
        np.testing.assert_allclose(got.arg_params[k].asnumpy(),
                                   want.arg_params[k].asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    test = rng.randn(12, 4).astype("f")
    p_want = want.predict(test)
    p_got = got.predict(test)
    assert isinstance(p_got, np.ndarray) and p_got.shape == (12, 3)
    np.testing.assert_allclose(p_got, p_want, rtol=RTOL, atol=ATOL)


def test_feedforward_predict_from_a_checkpoint(tmp_path):
    """``save``, ``FeedForward.load`` and a prediction that binds the
    module for inference, against the JAX model from the same file."""
    rng = np.random.RandomState(2)
    x = rng.randn(10, 4).astype("f")
    y = rng.randint(0, 3, 10).astype("f")
    prefix = str(tmp_path / "ff")
    _feedforward(mxt, x, y, 1).save(prefix)
    got = mxt.FeedForward.load(prefix, 1, ctx=mxt.cpu(),
                               numpy_batch_size=5).predict(x)
    want = mx.FeedForward.load(prefix, 1, ctx=mx.cpu(),
                               numpy_batch_size=5).predict(x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_feedforward_context_follows_the_scope():
    with mxt.cpu():
        assert mxt.FeedForward(_mlp(mxt)).ctx == mxt.cpu()
    assert mxt.FeedForward(_mlp(mxt)).ctx == mxt.gpu(0)


def _scoped(pkg):
    with pkg.AttrScope(ctx_group="stage1", lr_mult="0.5"):
        data = pkg.sym.var("data")
        fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc1")
        with pkg.AttrScope(ctx_group="stage2"):
            w = pkg.sym.var("w2", attr={"tag": "x"})
            out = pkg.sym.FullyConnected(fc, w, num_hidden=2, no_bias=True,
                                         name="fc2")
    bn = pkg.sym.BatchNorm(out, name="bn", attr={"note": "plain"})
    return bn


def test_attr_scope_in_attr_dict_and_json():
    got, want = _scoped(mxt), _scoped(mx)
    assert got.attr_dict() == want.attr_dict()
    assert got.attr_dict()["fc2"] == {"ctx_group": "stage2",
                                      "lr_mult": "0.5"}
    assert got.attr_dict()["w2"]["tag"] == "x"
    assert json.loads(got.tojson()) == json.loads(want.tojson())
    assert mxt.AttrScope.current().get(None) == {}
    with pytest.raises(ValueError):
        mxt.AttrScope(ctx_group=1)


def test_top_level_names():
    for name in ("seed", "Xavier", "Optimizer", "Symbol", "FeedForward",
                 "AttrScope", "NameManager", "__version__"):
        assert hasattr(mx, name) and hasattr(mxt, name), name
    assert mxt.seed is mxt.random.seed
    assert mxt.Xavier is mxt.initializer.Xavier
    assert mxt.Optimizer is mxt.optimizer.Optimizer
    assert mxt.Symbol is mxt.sym.Symbol
    assert mxt.FeedForward is mxt.model.FeedForward
    assert mxt.NameManager is mxt.name.NameManager
    assert mxt.__version__.split("+")[0] == mx.__version__.split("+")[0]
