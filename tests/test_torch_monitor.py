"""The port's Monitor against the JAX package's.

A small MLP ``Module`` (FullyConnected, Activation, FullyConnected,
SoftmaxOutput) is bound in both packages on the CPU with the same seeded
weights and batch; a ``Monitor`` is installed on each, with the default
stat (mean absolute value), with ``nan_count`` and with a pattern, and
one training forward runs between ``tic`` and ``toc``. The JAX side runs
with ``MXNET_XLA_STATS=0`` (its compile-tracking layer fails under the
installed JAX). The same ``toc()`` names must appear in the same order,
with values within 1e-5 (relative and absolute: f32 on both sides, only
summation order differs); ``monitor_all`` adds the variables in both.

On the port alone: a NaN in the batch books
``run_anomalies_total{kind="nonfinite_tensor"}`` under ``nan_count`` and
under the default stat, a clean batch books none; ``fit(monitor=)`` logs
``toc_print`` lines each batch; ``BucketingModule.install_monitor``
reaches every bucket, a bucket bound later too; the monitored graph runs
without the executor's folds (its outputs equal the folded graph's).
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

TOL = {"rtol": 1e-5, "atol": 1e-5}
BATCH, IN, HID, OUT = 6, 5, 7, 3


@pytest.fixture
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _module(pkg, seed=0):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=HID, name="fc1")
    net = pkg.sym.Activation(net, act_type="tanh", name="act1")
    net = pkg.sym.FullyConnected(net, num_hidden=OUT, name="fc2")
    net = pkg.sym.SoftmaxOutput(net, name="softmax")
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (BATCH, IN))],
             label_shapes=[("softmax_label", (BATCH,))])
    rng = np.random.RandomState(seed)
    arg = {"fc1_weight": rng.randn(HID, IN), "fc1_bias": rng.randn(HID),
           "fc2_weight": rng.randn(OUT, HID), "fc2_bias": rng.randn(OUT)}
    mod.init_params(arg_params={k: pkg.nd.array(v.astype(np.float32))
                                for k, v in arg.items()})
    return mod


def _batch(pkg, seed=0, nan=False):
    rng = np.random.RandomState(seed + 10)
    x = rng.randn(BATCH, IN).astype(np.float32)
    if nan:
        x[2, 3] = np.nan
    y = rng.randint(0, OUT, BATCH).astype(np.float32)
    return pkg.io.DataBatch(data=[pkg.nd.array(x)], label=[pkg.nd.array(y)])


def _toc(pkg, stat, pattern=".*", monitor_all=False, seed=0, nan=False):
    mod = _module(pkg, seed)
    mon = pkg.monitor.Monitor(1, stat_func=stat(pkg), pattern=pattern)
    mod.install_monitor(mon)
    if monitor_all:
        mod._exec.set_monitor_callback(mon.stat_helper, monitor_all=True)
    mon.tic()
    mod.forward(_batch(pkg, seed, nan), is_train=True)
    return [(name, [float(v) for v in text.split()])
            for _, name, text in mon.toc()]


STATS = {
    "default": lambda pkg: None,
    "nan_count": lambda pkg: pkg.monitor.nan_count,
    "max": lambda pkg: (lambda x: x.max()),
}


@pytest.mark.parametrize("stat", sorted(STATS))
@pytest.mark.parametrize("pattern,monitor_all", [(".*", False),
                                                 (".*fc.*", False),
                                                 (".*", True)])
def test_toc_matches(stat, pattern, monitor_all, _plain_jit):
    got = {pkg: _toc(pkg, STATS[stat], pattern, monitor_all)
           for pkg in (mx, mxt)}
    names = [n for n, _ in got[mx]]
    assert names == [n for n, _ in got[mxt]]
    assert names
    if pattern == ".*fc.*":
        assert names == ["fc1_output", "fc2_output"]
    if monitor_all:
        assert "fc1_weight" in names and "data" in names
    for (_, vj), (_, vt) in zip(got[mx], got[mxt]):
        np.testing.assert_allclose(vt, vj, **TOL)


def _anomalies():
    return mxt.runprof.snapshot()["anomaly_counts"].get("nonfinite_tensor",
                                                        0)


@pytest.mark.parametrize("stat", ["default", "nan_count"])
def test_nonfinite_books_an_anomaly(stat):
    before = _anomalies()
    _toc(mxt, STATS[stat])
    assert _anomalies() == before
    _toc(mxt, STATS[stat], nan=True)
    assert _anomalies() > before


def test_fit_with_monitor_logs_each_batch(caplog):
    mod = _module(mxt)
    rng = np.random.RandomState(1)
    it = mxt.io.NDArrayIter(rng.randn(4 * BATCH, IN).astype(np.float32),
                            rng.randint(0, OUT, 4 * BATCH).astype(
                                np.float32), batch_size=BATCH)
    mon = mxt.monitor.Monitor(2, pattern=".*fc2.*")
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, monitor=mon, batches_per_dispatch=4,
                optimizer_params={"learning_rate": 0.1})
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Batch:")]
    assert len(lines) == 2 and all("fc2_output" in ln for ln in lines)
    assert mon.exes == [mod._exec]


def test_monitored_graph_equals_the_folded_one():
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    net = tvision.ResNetV1(tvision.BasicBlockV1, [1, 1, 1, 1],
                           [8, 8, 16, 32, 64], classes=4, prefix="r_")
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu())
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    net(mxt.nd.array(x))
    sym = net._trace_symbol()
    params = {p.name: p.data() for p in net.collect_params().values()}
    outs = []
    for monitored in (False, True):
        exe = sym.simple_bind(mxt.cpu(), data=(2, 3, 32, 32))
        exe.copy_params_from(
            {n: params[n] for n in sym.list_arguments() if n in params},
            {n: params[n] for n in sym.list_auxiliary_states()})
        seen = []
        if monitored:
            exe.set_monitor_callback(lambda n, a: seen.append(n))
        outs.append(exe.forward(is_train=False, data=mxt.nd.array(x))[0]
                    .asnumpy())
        if monitored:
            assert any("relu" in n or "conv" in n for n in seen)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)


def test_bucketing_module_installs_on_every_bucket():
    def sym_gen(key):
        data = mxt.sym.Variable("data")
        net = mxt.sym.FullyConnected(data, num_hidden=3, name="fc")
        return (mxt.sym.SoftmaxOutput(net, name="softmax"), ("data",),
                ("softmax_label",))
    mod = mxt.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                  context=mxt.cpu())
    mod.bind(data_shapes=[("data", (2, 4))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params()
    mon = mxt.monitor.Monitor(1, pattern="fc.*")
    mod.install_monitor(mon)
    mod.switch_bucket(6, [("data", (2, 4))], [("softmax_label", (2,))])
    assert len(mon.exes) == 2
    mon.tic()
    mod.forward(mxt.io.DataBatch(data=[mxt.nd.ones((2, 4))],
                                 label=[mxt.nd.zeros((2,))], bucket_key=6,
                                 provide_data=[("data", (2, 4))],
                                 provide_label=[("softmax_label", (2,))]),
                is_train=False)
    assert [name for _, name, _ in mon.toc()] == ["fc_output"]
