"""Five small public methods of the port against the JAX package's, on
the CPU (ROADMAP C.13): ``Executor.output_dict``,
``io.DataDesc.get_batch_axis``, ``NDArrayIter.hard_reset`` (the JAX
package's own test, `tests/test_fixes.py`, run on both),
``EvalMetric.get_config`` (every registered metric) and
``Context.empty_cache`` (a no-op on the CPU in both packages; on the card
the port's empties PyTorch's cache, `tests/test_torch_cuda.py`). The JAX
side runs with ``MXNET_XLA_STATS=0``.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _executor(pkg, ctx):
    x = pkg.sym.var("x")
    fc = pkg.sym.FullyConnected(x, num_hidden=3, name="fc")
    out = pkg.sym.Group([pkg.sym.relu(fc, name="act"),
                         pkg.sym.Activation(fc, act_type="tanh", name="th")])
    rs = np.random.RandomState(0)
    args = {"x": rs.randn(2, 4), "fc_weight": rs.randn(3, 4),
            "fc_bias": rs.randn(3)}
    return out.bind(ctx, {k: pkg.nd.array(v.astype(np.float32), ctx=ctx)
                          for k, v in args.items()})


def test_executor_output_dict():
    te, je = _executor(mxt, mxt.cpu()), _executor(mx, mx.cpu())
    te.forward()
    je.forward()
    got, want = te.output_dict, je.output_dict
    assert list(got) == list(want) and len(got) == 2
    for name in want:
        np.testing.assert_allclose(got[name].asnumpy(),
                                   want[name].asnumpy(), rtol=1e-6)


@pytest.mark.parametrize("layout", [None, "NCHW", "NHWC", "TNC", "CN", "C"])
def test_data_desc_get_batch_axis(layout):
    assert mxt.io.DataDesc.get_batch_axis(layout) == \
        mx.io.DataDesc.get_batch_axis(layout)


def _first_after_hard_reset(pkg):
    data = np.arange(10, dtype="float32").reshape(10, 1)
    it = pkg.io.NDArrayIter(data, batch_size=4,
                            last_batch_handle="roll_over")
    list(it)  # leaves a 2-sample cache
    it.hard_reset()
    it.reset()
    return next(it).data[0].asnumpy()


def test_ndarray_iter_hard_reset_drops_roll_over_cache():
    got = _first_after_hard_reset(mxt)
    np.testing.assert_array_equal(got, _first_after_hard_reset(mx))
    assert got[0, 0] == 0.0


def test_ndarray_iter_hard_reset_restarts_a_plain_epoch():
    data = np.arange(12, dtype="float32").reshape(12, 1)
    for pkg in (mx, mxt):
        it = pkg.io.NDArrayIter(data, batch_size=4)
        next(it)
        it.hard_reset()
        assert [b.data[0].asnumpy()[0, 0] for b in it] == [0.0, 4.0, 8.0]


_METRICS = [("acc", {}), ("acc", {"axis": 0}), ("top_k_accuracy",
                                                {"top_k": 3}),
            ("f1", {}), ("perplexity", {"ignore_label": 0}), ("mae", {}),
            ("mse", {}), ("rmse", {}), ("ce", {"eps": 1e-8}), ("nll_loss", {}),
            ("pearsonr", {}), ("loss", {}),
            ("acc", {"output_names": ["o"], "label_names": ["l"]})]


@pytest.mark.parametrize("name,kwargs", _METRICS)
def test_metric_get_config(name, kwargs):
    assert mxt.metric.create(name, **kwargs).get_config() == \
        mx.metric.create(name, **kwargs).get_config()


def test_custom_and_composite_metric_get_config():
    def feval(label, pred):
        return 0.0
    got = mxt.metric.CustomMetric(feval, allow_extra_outputs=True) \
        .get_config()
    want = mx.metric.CustomMetric(feval, allow_extra_outputs=True) \
        .get_config()
    assert got == want
    assert mxt.metric.CompositeEvalMetric().get_config() == \
        mx.metric.CompositeEvalMetric().get_config()


def test_context_empty_cache_on_the_cpu():
    assert mxt.cpu().empty_cache() is None
    assert mx.cpu().empty_cache() is None
    with pytest.raises(mxt.MXNetError, match="CUDA device"):
        mxt.gpu(0).empty_cache()
