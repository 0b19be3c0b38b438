"""``BucketingModule`` and the ``Module`` features it rests on, on the
CPU, against the JAX package.

C.8 first: a ``Module`` or ``BucketingModule`` made without a context
takes the enclosing ``with ctx:`` scope's (the JAX package takes the
scope's too), else ``gpu(0)``, which raises on a host without a card.
Then the bucketed word LM of `examples/rnn/word_lm` at narrow widths
(vocab 30, embed 8, hidden 8), as a ``FusedRNNCell`` stack and as the
example's unrolled ``LSTMCell`` stack: 3 SGD steps over 2 buckets (lr 1,
``clip_gradient`` 0.25, the slice's optimizer), from the same
parameters, in both packages; outputs and parameters after every step at
rtol 1e-5 (f32 both sides, differing in summation order only, which lr 1
carries into the next step), and the buckets' parameter and gradient
arrays, and the updater, one object. ``fit`` and ``score`` over a
``BucketSentenceIter`` end at the JAX package's perplexity. The JAX
package runs with ``MXNET_XLA_STATS=0`` (see `test_torch_module.py`).
"""
import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

V, E, H, BATCH = 30, 8, 8, 4
OPT = {"learning_rate": 1.0, "clip_gradient": 0.25}
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _plain_jit(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _mlp(pkg):
    data = pkg.sym.var("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
    return pkg.sym.SoftmaxOutput(fc, name="softmax")


# -- C.8 ---------------------------------------------------------------------
def test_c8_module_takes_the_scope_context():
    """Under ``with mx.cpu():`` a ctx-less Module builds on the CPU, as
    the JAX package's does; outside every scope it takes ``gpu(0)``,
    which needs a card."""
    with mx.cpu():
        ref = mx.mod.Module(_mlp(mx))
    with mxt.cpu():
        mod = mxt.mod.Module(_mlp(mxt))
    assert [str(c) for c in ref._context] == ["cpu(0)"]
    assert mod._context == mxt.cpu()
    mod.bind(data_shapes=[("data", (2, 4))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params()
    assert mod.get_params()[0]["fc_weight"].context == mxt.cpu()
    assert mod.get_params()[0]["fc_weight"].data.device.type == "cpu"
    if mxt.num_gpus() == 0:
        with pytest.raises(mxt.MXNetError):
            mxt.mod.Module(_mlp(mxt))
    else:
        assert mxt.mod.Module(_mlp(mxt))._context == mxt.gpu(0)


def test_c8_bucketing_module_takes_the_scope_context():
    """The scope is read when the BucketingModule is made: its buckets,
    bound later outside the scope, stay on the CPU."""
    def sym_gen(key):
        return _mlp(mxt), ("data",), ("softmax_label",)
    with mxt.cpu():
        mod = mxt.mod.BucketingModule(sym_gen, default_bucket_key=4)
    mod.bind(data_shapes=[("data", (2, 4))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params()
    assert mod._curr_module._context == mxt.cpu()
    assert mod.get_params()[0]["fc_weight"].data.device.type == "cpu"
    if mxt.num_gpus() == 0:
        with pytest.raises(mxt.MXNetError):
            mxt.mod.BucketingModule(sym_gen, default_bucket_key=4).bind(
                data_shapes=[("data", (2, 4))],
                label_shapes=[("softmax_label", (2,))])


# -- the bucketed LM -----------------------------------------------------------
def _fused_gen(pkg):
    cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="lstm_")

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E,
                                  name="embed")
        out, _ = cell.unroll(seq_len, embed, layout="NTC",
                             merge_outputs=True)
        pred = pkg.sym.FullyConnected(pkg.sym.Reshape(out, shape=(-1, H)),
                                      num_hidden=V, name="pred")
        pred = pkg.sym.SoftmaxOutput(pred, pkg.sym.Reshape(label,
                                                           shape=(-1,)),
                                     name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _unrolled_gen(pkg):
    """`examples/rnn/word_lm/train.py:67-85`'s construction."""
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(num_hidden=H, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E,
                                  name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, layout="NTC",
                                  merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, H))
        pred = pkg.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


GENS = {"fused": _fused_gen, "unrolled": _unrolled_gen}


def _batch(pkg, key, seed):
    rng = np.random.RandomState(seed)
    d = rng.randint(1, V, (BATCH, key)).astype(np.float32)
    lb = np.concatenate([d[:, 1:], np.zeros((BATCH, 1), np.float32)], 1)
    return pkg.io.DataBatch(
        data=[pkg.nd.array(d, ctx=pkg.cpu())],
        label=[pkg.nd.array(lb, ctx=pkg.cpu())], bucket_key=key,
        provide_data=[pkg.io.DataDesc("data", (BATCH, key))],
        provide_label=[pkg.io.DataDesc("softmax_label", (BATCH, key))])


def _bucketing(pkg, gen, init=None):
    mod = pkg.mod.BucketingModule(gen(pkg), default_bucket_key=6,
                                  context=pkg.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH, 6))])
    if init is None:
        np.random.seed(0)
        mod.init_params(initializer=pkg.init.Xavier())
    else:
        mod.init_params(initializer=None, arg_params=init)
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return mod


def _np_params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("gen", sorted(GENS))
def test_bucketed_lm_matches(gen):
    """3 steps over buckets 6, 3, 6 from the JAX module's parameters:
    outputs and parameters after every step; the new bucket's executor
    holds the default bucket's parameter and gradient arrays and its
    updater."""
    ref = _bucketing(mx, GENS[gen])
    mod = _bucketing(mxt, GENS[gen], init=_np_params(ref))
    for step, key in enumerate((6, 3, 6)):
        for pkg, m in ((mx, ref), (mxt, mod)):
            m.forward_backward(_batch(pkg, key, step))
            m.update()
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                   ref.get_outputs()[0].asnumpy(),
                                   rtol=RTOL, atol=ATOL)
        want, got = _np_params(ref), _np_params(mod)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    assert sorted(mod._buckets) == sorted(ref._buckets) == [3, 6]
    big, small = mod._buckets[6], mod._buckets[3]
    for name in big._param_names:
        assert small._exec.arg_dict[name] is big._exec.arg_dict[name]
        assert small._exec.grad_dict[name] is big._exec.grad_dict[name]
    assert small._updater is big._updater
    assert small._optimizer is big._optimizer
    assert small._exec.arg_dict["data"] is not big._exec.arg_dict["data"]


def test_bucketing_module():
    """`tests/test_module.py::test_bucketing_module` in both packages:
    two buckets of one FullyConnected, three steps; the bias is one
    array, and its values agree."""
    def make(pkg):
        def sym_gen(seq_len):
            fc = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=8,
                                        name="fc")
            return pkg.sym.SoftmaxOutput(fc, name="softmax"), ("data",), \
                ("softmax_label",)
        mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                      context=pkg.cpu())
        mod.bind(data_shapes=[("data", (4, 10))],
                 label_shapes=[("softmax_label", (4,))])
        np.random.seed(1)
        mod.init_params()
        mod.init_optimizer(optimizer="sgd")
        for key, dim in [(10, 10), (5, 5), (10, 10)]:
            batch = pkg.io.DataBatch(
                data=[pkg.nd.ones((4, dim), ctx=pkg.cpu())],
                label=[pkg.nd.zeros((4,), ctx=pkg.cpu())], bucket_key=key,
                provide_data=[pkg.io.DataDesc("data", (4, dim))],
                provide_label=[pkg.io.DataDesc("softmax_label", (4,))])
            mod.forward_backward(batch)
            mod.update()
        return mod
    ref, mod = make(mx), make(mxt)
    assert len(mod._buckets) == 2
    assert mod._buckets[10]._exec.arg_dict["fc_bias"] is \
        mod._buckets[5]._exec.arg_dict["fc_bias"]
    # the dim-5 bucket's weight has its own shape: not shared, as in
    # the JAX package
    for name in ("fc_bias",):
        np.testing.assert_allclose(
            mod._buckets[10]._exec.arg_dict[name].asnumpy(),
            ref._buckets[10]._exec.arg_dict[name].asnumpy(), rtol=RTOL,
            atol=ATOL)


def _fit_score(pkg, sentences):
    random.seed(3)
    np.random.seed(3)
    it = pkg.rnn.BucketSentenceIter(sentences, BATCH, buckets=[4, 8],
                                    invalid_label=0)
    mod = pkg.mod.BucketingModule(_fused_gen(pkg),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    np.random.seed(4)
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            eval_metric=pkg.metric.Perplexity(ignore_label=None),
            initializer=pkg.init.Xavier())
    random.seed(5)
    np.random.seed(5)
    it.reset()
    return dict(mod.score(it, pkg.metric.Perplexity(ignore_label=None))), \
        mod


def test_fit_and_score_match():
    """One ``fit`` epoch and a ``score`` over a ``BucketSentenceIter``
    (buckets 4 and 8) end at the JAX package's perplexity."""
    rng = np.random.RandomState(2)
    sentences = [list(rng.randint(1, V, rng.randint(2, 9)))
                 for _ in range(40)]
    want, _ = _fit_score(mx, sentences)
    got, mod = _fit_score(mxt, sentences)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-4)
    assert sorted(mod._buckets) == [4, 8]


def test_params_states_and_refusals():
    """``get_params``/``set_params`` through the current bucket,
    ``get_states``/``set_states`` of the state names, and what the JAX
    package refuses."""
    def sym_gen(key):
        data = mxt.sym.var("data")
        st = mxt.sym.var("st")
        fc = mxt.sym.FullyConnected(data, num_hidden=3, name="fc") + st
        return mxt.sym.SoftmaxOutput(fc, name="softmax"), ("data",), \
            ("softmax_label",)
    mod = mxt.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                  context=mxt.cpu(), state_names=["st"])
    with pytest.raises(AssertionError):
        mod.switch_bucket(2, [("data", (2, 2))])
    with pytest.raises(AssertionError):
        mod.bind(data_shapes=[("data", (2, 4))],
                 label_shapes=[("softmax_label", (2,))],
                 shared_module=object())
    mod.bind(data_shapes=[("data", (2, 4))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params()
    args, _ = mod.get_params()
    new = {k: np.full(v.shape, 0.5, np.float32) for k, v in args.items()}
    mod.set_params(new, {})
    assert np.all(mod.get_params()[0]["fc_weight"].asnumpy() == 0.5)
    mod.set_states(value=2.0)
    assert np.all(mod.get_states()[0].asnumpy() == 2.0)
    assert mod.data_names == ["data"] and mod.output_names == \
        ["softmax_output"]
    with pytest.raises(mxt.MXNetError):
        mxt.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                context=mxt.cpu(), group2ctxs=[{}])
    with pytest.raises(mxt.MXNetError):
        mxt.mod.Module(_mlp(mxt), context=mxt.cpu()).borrow_optimizer(
            mxt.mod.Module(_mlp(mxt), context=mxt.cpu()))
