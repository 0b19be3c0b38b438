"""The training slice of the port on the CPU, against the JAX package.

A small word LM (vocab 50, embed 16, 2x16 LSTM, T=5, B=4; the graph of
`examples/rnn/word_lm/benchmark.py` at narrow widths) trains through both
packages' ``Module`` at lr 1 with ``clip_gradient`` 0.25, from the same
parameters, and the outputs and parameters are compared after every
step. The JAX package runs with its compile-tracking layer switched off
(``MXNET_XLA_STATS=0``, its documented kill switch: plain ``jax.jit``):
under the installed JAX that layer calls ``jax.core.trace_state_clean``,
which is gone. Tolerance 1e-4, the JAX package's own gradient tolerance
(`test_pallas.py`): both sides are f32 and differ in summation order
only, which lr 1 carries into the next step. The file also holds
``io.NDArrayIter`` and the metrics against the JAX package's, exactly.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import lstm_kernel

T, B, V, E, H = 5, 4, 50, 16, 16
TOL = 1e-4
OPT = {"learning_rate": 1.0, "clip_gradient": 0.25}


@pytest.fixture(autouse=True)
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def lm(pkg, reshape_label=False):
    """The benchmark's graph; with ``reshape_label`` the label is a (T, B)
    input reshaped in the graph (the reference word_lm train.py form)."""
    data = pkg.sym.var("data")
    x = pkg.sym.Embedding(data, input_dim=V, output_dim=E, name="embed")
    x = pkg.sym.RNN(x, state_size=H, num_layers=2, mode="lstm",
                    name="lstm")
    x = pkg.sym.FullyConnected(pkg.sym.Reshape(x, shape=(-1, H)),
                               num_hidden=V, name="decoder")
    if reshape_label:
        label = pkg.sym.Reshape(pkg.sym.var("softmax_label"), shape=(-1,))
        return pkg.sym.SoftmaxOutput(x, label, name="softmax")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _seed(pkg, seed):
    # the port's seed() seeds numpy's generator; the JAX package's does not
    if pkg is mxt:
        mxt.random.seed(seed)
    else:
        np.random.seed(seed)


def module(pkg, seed=0, opt=OPT, **bind_kw):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(lm(pkg), context=ctx)
    mod.bind(data_shapes=[("data", (T, B))],
             label_shapes=[("softmax_label", (T * B,))], **bind_kw)
    _seed(pkg, seed)
    mod.init_params(initializer=pkg.init.Xavier())
    if opt is not None:
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    return mod


def batches(pkg, n, seed=1):
    rng = np.random.RandomState(seed)
    return [pkg.io.DataBatch(
        data=[pkg.nd.array(rng.randint(0, V, (T, B)).astype(np.float32))],
        label=[pkg.nd.array(rng.randint(0, V, T * B).astype(np.float32))])
        for _ in range(n)]


def params(mod):
    return mxt.params_to_numpy(mod.get_params()[0])


def assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_seeded_init_is_bit_identical():
    want, got = params(module(mx)), params(module(mxt))
    assert sorted(got) == ["decoder_bias", "decoder_weight", "embed_weight",
                           "lstm_parameters", "lstm_state",
                           "lstm_state_cell"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_three_steps_match_jax():
    jmod = module(mx, seed=7)
    tmod = module(mxt, seed=123)
    tmod.set_params(params(jmod), {})   # a JAX module's weights, as numpy
    assert_params_close(params(tmod), params(jmod))
    for jb, tb in zip(batches(mx, 3), batches(mxt, 3)):
        jmod._step(jb)
        tmod._step(tb)
        got, want = (m.get_outputs()[0].asnumpy() for m in (tmod, jmod))
        assert got.shape == (T * B, V)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert_params_close(params(tmod), params(jmod))


def test_step_scan_matches_jax():
    jmod, tmod = module(mx), module(mxt)
    want = jmod._step_scan(batches(mx, 3, seed=2))
    got = tmod._step_scan(batches(mxt, 3, seed=2))
    assert len(got) == 1 and got[0].shape == (3, T * B, V)
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               got[0].asnumpy()[-1])
    assert_params_close(params(tmod), params(jmod))


def test_gradients_reach_the_lstm_and_the_embedding():
    # a graph trained on any device gets gradients through the RNN op
    jmod, tmod = module(mx, opt=None), module(mxt, opt=None)
    jb, tb = batches(mx, 1, seed=3)[0], batches(mxt, 1, seed=3)[0]
    jmod.forward_backward(jb)
    before = lstm_kernel.fused_lstm_train.launches
    tmod.forward_backward(tb)
    assert lstm_kernel.fused_lstm_train.launches == before   # CPU: plain
    for name in ("lstm_parameters", "embed_weight", "lstm_state",
                 "decoder_weight"):
        got = tmod._exec.grad_dict[name].asnumpy()
        want = np.asarray(jmod._exec.grad_dict[name].asnumpy())
        assert np.abs(got).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_token_ids_take_no_gradient():
    """Embedding differentiates its weight, never the integer ids."""
    grads = []
    for pkg in (mx, mxt):
        mod = module(pkg, opt=None, inputs_need_grad=True)
        mod.forward_backward(batches(pkg, 1, seed=17)[0])
        grads.append((np.asarray(mod.get_input_grads()[0].asnumpy()),
                      mod._exec.grad_dict["embed_weight"].asnumpy()))
    (jids, jemb), (tids, temb) = grads
    assert tids.shape == (T, B) and not tids.any() and not jids.any()
    np.testing.assert_allclose(temb, np.asarray(jemb), rtol=TOL, atol=TOL)


def _iter(pkg, nbatch, seed):
    rng = np.random.RandomState(seed)
    shape = (nbatch * T, B)
    return pkg.io.NDArrayIter(
        rng.randint(0, V, shape).astype(np.float32),
        rng.randint(0, V, shape).astype(np.float32), batch_size=T)


def test_fit_and_score_match_jax():
    results = []
    for pkg in (mx, mxt):
        mod = pkg.mod.Module(lm(pkg, reshape_label=True),
                             context=pkg.cpu())
        metric = pkg.metric.Perplexity()
        _seed(pkg, 4)
        mod.fit(_iter(pkg, 4, seed=5), eval_metric=metric,
                optimizer="sgd", optimizer_params=OPT,
                initializer=pkg.init.Xavier(), num_epoch=2)
        (_, ppl), = mod.score(_iter(pkg, 2, seed=6), pkg.metric.Perplexity())
        results.append((metric.get()[1], ppl, params(mod)))
    (jtrain, jeval, jparams), (ttrain, teval, tparams) = results
    np.testing.assert_allclose([ttrain, teval], [jtrain, jeval], rtol=TOL)
    assert_params_close(tparams, jparams)


def test_fit_in_groups_matches_fit_per_batch():
    out = []
    for k in (1, 3):
        mod = mxt.mod.Module(lm(mxt, reshape_label=True), context=mxt.cpu())
        metric = mxt.metric.Perplexity()
        speedo = mxt.callback.Speedometer(T * B, frequent=2)
        mxt.random.seed(8)
        mod.fit(_iter(mxt, 5, seed=9), eval_metric=metric,
                batch_end_callback=speedo, optimizer="sgd",
                optimizer_params=OPT, initializer=mxt.init.Xavier(),
                num_epoch=1, batches_per_dispatch=k)
        assert [c for _, c, _ in speedo.history] == [2, 4]
        out.append((metric.get()[1], params(mod)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    assert_params_close(out[1][1], out[0][1])


def test_module_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="CUDA device 0"):
        mxt.mod.Module(lm(mxt))
    assert mxt.mod.Module(lm(mxt), context=mxt.cpu()).binded is False


def test_batches_on_another_device_are_copied_in():
    mod = module(mxt)
    batch = batches(mxt, 1)[0]
    mod.forward(batch, is_train=False)
    assert mod.get_outputs()[0].context == mxt.cpu()
    staged = mod.stack_batches(batches(mxt, 2))
    np.testing.assert_array_equal(staged[1].data[0].asnumpy(),
                                  batches(mxt, 2)[1].data[0].asnumpy())


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
def test_grad_req(grad_req):
    mod = module(mxt, opt=None, grad_req=grad_req)
    batch = batches(mxt, 1, seed=10)[0]
    mod.forward_backward(batch)
    if grad_req == "null":
        assert mod._exec.grad_dict == {}
        return
    once = mod._exec.grad_dict["decoder_weight"].asnumpy().copy()
    mod.forward_backward(batch)
    twice = mod._exec.grad_dict["decoder_weight"].asnumpy()
    np.testing.assert_allclose(twice, once * (2 if grad_req == "add" else 1),
                               rtol=1e-5, atol=1e-7)


def test_inputs_need_grad_and_head_gradients_match_jax():
    """A non-loss head takes the given out_grads, as in the JAX executor."""
    rng = np.random.RandomState(11)
    x, w = rng.randn(3, 4).astype(np.float32), rng.randn(2, 4)
    g = rng.randn(3, 2).astype(np.float32)
    grads = []
    for pkg in (mx, mxt):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=2,
                                     name="fc")
        mod = pkg.mod.Module(net, label_names=None, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (3, 4))], inputs_need_grad=True)
        mod.set_params({"fc_weight": pkg.nd.array(w),
                        "fc_bias": pkg.nd.array(np.zeros(2))}, {})
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x)]), is_train=True)
        mod.backward(out_grads=[pkg.nd.array(g)])
        grads.append((mod.get_input_grads()[0].asnumpy(),
                      mod._exec.grad_dict["fc_weight"].asnumpy()))
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_checkpoint_round_trip_and_jax_reads_it(tmp_path):
    mod = module(mxt)
    mod._step(batches(mxt, 1)[0])
    prefix = str(tmp_path / "lm")
    mod.save_checkpoint(prefix, 3)
    loaded = mxt.mod.Module.load(prefix, 3, context=mxt.cpu())
    loaded.bind(data_shapes=[("data", (T, B))],
                label_shapes=[("softmax_label", (T * B,))])
    want = params(mod)
    assert_params_close(params(loaded), want)
    _, jargs, _ = mx.model.load_checkpoint(prefix, 3)
    for name, arr in jargs.items():
        np.testing.assert_array_equal(arr.asnumpy(), want[name])


def test_random_seed_fixes_dropout_masks():
    def run():
        mxt.random.seed(12)
        data = mxt.sym.var("data")
        net = mxt.sym.RNN(data, state_size=6, num_layers=2, mode="lstm",
                          p=0.5, name="lstm")
        ex = net.simple_bind(mxt.cpu(), grad_req="null", data=(3, 2, 4))
        ex.arg_dict["data"][:] = np.ones((3, 2, 4), np.float32)
        ex.arg_dict["lstm_parameters"][:] = 0.1
        return [ex.forward(is_train=True)[0].asnumpy() for _ in range(2)]
    first, second = run(), run()
    np.testing.assert_array_equal(first[0], second[0])
    np.testing.assert_array_equal(first[1], second[1])
    assert not np.array_equal(first[0], first[1])


# ---------------------------------------------------------------------------
# io and metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    data = np.arange(22 * 3, dtype=np.float32).reshape(22, 3)
    label = np.arange(22, dtype=np.float32)
    epochs = []
    for pkg in (mx, mxt):
        np.random.seed(13)
        it = pkg.io.NDArrayIter(data, label, batch_size=5, shuffle=shuffle,
                                last_batch_handle=handle)
        assert [tuple(d.shape) for d in it.provide_data] == [(5, 3)]
        assert [tuple(d.shape) for d in it.provide_label] == [(5,)]
        seen = []
        for _ in range(2):
            seen.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                         for b in it])
            it.reset()
        epochs.append(seen)
    for jep, tep in zip(*epochs):
        assert len(tep) == len(jep)
        for (jd, jl, jp), (td, tl, tp) in zip(jep, tep):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp


def _metric_inputs(seed):
    rng = np.random.RandomState(seed)
    probs = rng.rand(12, 7).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    label = rng.randint(0, 7, 12).astype(np.float32)
    return label, probs


@pytest.mark.parametrize("name,kwargs", [
    ("perplexity", {}), ("perplexity", {"ignore_label": 3}),
    ("acc", {}), ("ce", {}), ("loss", {}),
])
def test_metrics_match_jax(name, kwargs):
    values = []
    for pkg in (mx, mxt):
        metric = pkg.metric.create(name, **kwargs)
        for seed in (14, 15):
            label, probs = _metric_inputs(seed)
            metric.update([pkg.nd.array(label)], [pkg.nd.array(probs)])
        values.append(metric.get_name_value())
    (jname, jval), = values[0]
    (tname, tval), = values[1]
    assert tname == jname
    np.testing.assert_allclose(tval, jval, rtol=1e-6)


def test_composite_metric_and_update_dict():
    metric = mxt.metric.create(["acc", mxt.metric.Perplexity()])
    label, probs = _metric_inputs(16)
    metric.update_dict({"softmax_label": mxt.nd.array(label)},
                       {"softmax_output": mxt.nd.array(probs)})
    names, vals = metric.get()
    assert names == ["accuracy", "perplexity"]
    assert 0 <= vals[0] <= 1 and vals[1] > 1


def test_speedometer_logs_every_frequent_batches(caplog):
    speedo = mxt.callback.Speedometer(batch_size=8, frequent=2)
    metric = mxt.metric.Loss()
    metric.update(None, [mxt.nd.array(np.ones(4))])
    with caplog.at_level(logging.INFO):
        for n in range(5):
            speedo(mxt.model.BatchEndParam(0, n, metric))
    assert [c for _, c, _ in speedo.history] == [2, 4]
    assert "Speed" in caplog.text and "loss" in caplog.text


def test_executor_calls_a_hold_at_every_node_and_gradient():
    """The sampled step's hold points (`module._Holds`): the training
    forward calls ``node`` after each op node with its outputs, each
    output's gradient ticks in the backward, and each gradient's copy
    ticks; the gradients are those of a step without a hold."""
    class Recording:
        def __init__(self):
            self.nodes, self.ticks = 0, 0

        def node(self, outs):
            self.nodes += 1
            for o in outs:
                if o.requires_grad:
                    o.register_hook(self.tick)

        def tick(self, *_):
            self.ticks += 1

    mod = module(mxt)
    grads = []
    for hold in (None, Recording()):
        mod._exec._hold = hold
        mod.forward_backward(batches(mxt, 1)[0])
        mod._exec._hold = None
        grads.append({n: a.asnumpy() for n, a in
                      mod._exec.grad_dict.items()})
    ops = [n for n in lm(mxt)._topo_nodes() if not n.is_var()]
    assert hold.nodes == len(ops)
    # one tick a gradient copy, at least one a node reached backwards
    assert hold.ticks >= len(mod._exec._grad_names) + 3
    for name, g in grads[0].items():
        np.testing.assert_array_equal(grads[1][name], g)


@pytest.mark.parametrize("pkg", [mx, mxt], ids=["jax", "torch"])
def test_asnumpy_is_a_snapshot(pkg):
    """``asnumpy`` returns the values as they are when it is called (the
    reference's docstring: "a copy"): writes into the NDArray afterwards,
    whole or in part, and the optimizer's in-place update, leave the
    returned array as it was. Exact."""
    a = pkg.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    snap = a.asnumpy()
    a[:] = 7.0
    a[0] = np.zeros(3, np.float32)
    updater = pkg.optimizer.get_updater(
        pkg.optimizer.create("sgd", learning_rate=0.5, momentum=0.9))
    updater(0, pkg.nd.array(np.ones((2, 3), np.float32)), a)
    np.testing.assert_array_equal(
        snap, np.arange(6, dtype=np.float32).reshape(2, 3))
    assert not np.array_equal(a.asnumpy(), snap)
