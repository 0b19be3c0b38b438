"""The port's Gluon layers against the JAX package's, on the CPU.

C.6 (ROADMAP §C): ``Dense(activation=...)`` and ``Conv2D(activation=...)``
for every act type the port's ``Activation`` has, with the JAX package's
child naming (``Activation(act, prefix=act + "_")``, so parameter names
and ``collect_params()`` match); and the layers of this slice:
``Sequential``, ``Dropout``, ``Embedding``, ``LayerNorm``, ``Lambda``,
``HybridLambda``, ``LeakyReLU``, ``AvgPool2D``, ``GlobalMaxPool2D``,
``gluon.Constant`` and ``gluon.split_and_load``; and the 1-D
convolution and pools, NCW and NWC. Each net is built in
both packages under one prefix, the JAX net's initial weights are copied
into the port's, and the forward output, the input gradient and every
parameter gradient of ``sum(out * r + out ** 2)`` (``r`` fixed draws)
are held to rtol 1e-5, atol
1e-6 (f32 both sides), eager and hybridized.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RTOL, ATOL = 1e-5, 1e-6
CPU = mxt.cpu()
ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def _pair(build):
    """``build(pkg)`` in both packages, initialised on the CPU, the port's
    weights set to the JAX net's."""
    nets = []
    for pkg in (mx, mxt):
        with pkg.cpu():
            net = build(pkg)
            net.initialize(pkg.init.Xavier())
        nets.append(net)
    jp, tp = nets[0].collect_params(), nets[1].collect_params()
    assert sorted(jp.keys()) == sorted(tp.keys())
    for name in jp.keys():
        tp[name].set_data(mxt.nd.array(jp[name].data().asnumpy(), ctx=CPU))
    return nets


def _loss(pkg, out):
    """``sum(out * r + out ** 2)``, ``r`` fixed normal draws of ``out``'s
    shape (a normalising layer makes ``sum(out ** 2)`` a constant)."""
    r = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    return (out * pkg.nd.array(r, ctx=pkg.cpu()) + out * out).sum()


def _run(net, pkg, x, hybridize=False, train=False):
    """Output, input gradient and parameter gradients of ``_loss``."""
    if hybridize:
        net.hybridize()
    a = pkg.nd.array(x, ctx=pkg.cpu())
    a.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = net(a)
        loss = _loss(pkg, out)
    loss.backward()
    params = net.collect_params()
    grads = {n: p.grad().asnumpy() for n, p in sorted(params.items())
             if p.grad_req != "null"}
    return out.asnumpy(), a.grad.asnumpy(), grads


def _compare(nets, x, hybridize=False):
    want = _run(nets[0], mx, x, hybridize)
    got = _run(nets[1], mxt, x, hybridize)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert sorted(got[2]) == sorted(want[2])
    for name in want[2]:
        np.testing.assert_allclose(got[2][name], want[2][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _seq(pkg, *layers, hybrid=True):
    net = (pkg.gluon.nn.HybridSequential if hybrid
           else pkg.gluon.nn.Sequential)(prefix="net_")
    with net.name_scope():
        net.add(*[make(pkg) for make in layers])
    return net


# -- C.6 ---------------------------------------------------------------------
@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_c6_dense_activation(act, hybridize):
    nets = _pair(lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(5, activation=act, in_units=4),
        lambda p: p.gluon.nn.Dense(3, in_units=5)))
    assert nets[1][0].act.name == nets[0][0].act.name == \
        "net_dense0_%s" % act
    assert nets[1][1].act is None
    _compare(nets, _x(6, 4), hybridize)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_c6_conv2d_activation(act, hybridize):
    nets = _pair(lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Conv2D(4, 3, padding=1, activation=act,
                                         in_channels=2)))
    assert nets[1][0].act.name == nets[0][0].act.name == \
        "net_conv0_%s" % act
    _compare(nets, _x(2, 2, 5, 5), hybridize)


def test_c6_activation_in_a_traced_symbol():
    """The activation child shows in the Symbol the block traces."""
    nets = _pair(lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(3, activation="tanh", in_units=4)))
    x = _x(2, 4)
    for net, pkg in zip(nets, (mx, mxt)):
        net(pkg.nd.array(x, ctx=pkg.cpu()))
    names = [n._trace_symbol().get_internals().list_outputs() for n in nets]
    assert [o for o in names[1] if "tanh" in o] == \
        [o for o in names[0] if "tanh" in o]


# -- the new layers ----------------------------------------------------------
LAYERS = {
    "Sequential": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(5, in_units=4),
        lambda p: p.gluon.nn.Dense(2, activation="relu", in_units=5),
        hybrid=False), (6, 4)),
    "Dropout": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(5, in_units=4),
        lambda p: p.gluon.nn.Dropout(0.5)), (6, 4)),
    "Embedding": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Embedding(7, 3)), None),
    "LayerNorm": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(6, in_units=4),
        lambda p: p.gluon.nn.LayerNorm(in_channels=6)), (5, 4)),
    "LayerNorm_axis1": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.LayerNorm(axis=1, in_channels=3)),
        (2, 3, 4)),
    "Lambda": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(5, in_units=4),
        lambda p: p.gluon.nn.Lambda("tanh"),
        lambda p: p.gluon.nn.Lambda(lambda x: x * 2.0 + 1.0), hybrid=False),
        (6, 4)),
    "HybridLambda": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(5, in_units=4),
        lambda p: p.gluon.nn.HybridLambda("sigmoid"),
        lambda p: p.gluon.nn.HybridLambda(lambda F, x: F.relu(x - 0.5))),
        (6, 4)),
    "LeakyReLU": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(5, in_units=4),
        lambda p: p.gluon.nn.LeakyReLU(0.1)), (6, 4)),
    "AvgPool2D": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Conv2D(3, 3, in_channels=2),
        lambda p: p.gluon.nn.AvgPool2D(3, 2, padding=1)), (2, 2, 9, 9)),
    "AvgPool2D_no_pad_count": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.AvgPool2D(
            2, 2, padding=1, ceil_mode=True, count_include_pad=False)),
        (2, 3, 7, 7)),
    "GlobalMaxPool2D": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Conv2D(3, 3, in_channels=2),
        lambda p: p.gluon.nn.GlobalMaxPool2D()), (2, 2, 6, 6)),
    # the 1-D layers, NCW and NWC (train_cnn_text.py's Conv1D over NCW
    # and GlobalMaxPool1D)
    "Conv1D_GlobalMaxPool1D": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Conv1D(4, 3, activation="relu",
                                         in_channels=2),
        lambda p: p.gluon.nn.GlobalMaxPool1D()), (2, 2, 9)),
    "Conv1D_NWC_MaxPool1D": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Conv1D(4, 3, strides=2, padding=1,
                                         layout="NWC", in_channels=3),
        lambda p: p.gluon.nn.MaxPool1D(2, layout="NWC")), (2, 11, 3)),
    "AvgPool1D": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Conv1D(3, 2, dilation=2, in_channels=2),
        lambda p: p.gluon.nn.AvgPool1D(3, 2, padding=1)), (2, 2, 10)),
    "AvgPool1D_NWC_GlobalAvgPool1D": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.AvgPool1D(2, ceil_mode=True,
                                            layout="NWC"),
        lambda p: p.gluon.nn.GlobalAvgPool1D(layout="NWC")), (2, 7, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients(name):
    build, shape = LAYERS[name]
    nets = _pair(build)
    if shape is None:      # Embedding: indices in, no input gradient
        ids = np.array([[0, 6, 2], [3, 3, 1]], np.float32)
        outs = []
        for net, pkg in zip(nets, (mx, mxt)):
            with pkg.autograd.record():
                out = net(pkg.nd.array(ids, ctx=pkg.cpu()))
                loss = _loss(pkg, out)
            loss.backward()
            outs.append((out.asnumpy(), [p.grad().asnumpy() for _, p in
                                         sorted(net.collect_params()
                                                .items())]))
        np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=RTOL,
                                   atol=ATOL)
        for g, w in zip(outs[1][1], outs[0][1]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        return
    _compare(nets, _x(*shape))


@pytest.mark.parametrize("name", ["Dropout", "LayerNorm", "HybridLambda",
                                  "LeakyReLU", "AvgPool2D",
                                  "GlobalMaxPool2D"])
def test_hybridized_layer(name):
    build, shape = LAYERS[name]
    _compare(_pair(build), _x(*shape), hybridize=True)


def test_dropout_in_training_drops_and_scales():
    net = mxt.gluon.nn.Dropout(0.5)
    x = mxt.nd.array(np.ones((128, 128), np.float32), ctx=CPU)
    with mxt.autograd.record():
        out = net(x)
    vals = out.asnumpy()
    assert set(np.unique(vals)) == {0.0, 2.0}
    assert abs((vals == 0).mean() - 0.5) < 4 * 0.5 / 128
    np.testing.assert_array_equal(net(x).asnumpy(), x.asnumpy())


def test_sequential_indexing_and_len():
    for pkg in (mx, mxt):
        net = _seq(pkg, lambda p: p.gluon.nn.Dense(3, in_units=2),
                   lambda p: p.gluon.nn.Dense(4, in_units=3),
                   lambda p: p.gluon.nn.Dense(5, in_units=4), hybrid=False)
        assert len(net) == 3
        assert isinstance(net[1:], pkg.gluon.nn.Sequential) and \
            len(net[1:]) == 2
        assert net[2] is list(net._children.values())[2]


def test_constant_parameter():
    """Both packages' initializers dispatch on the name's suffix, so the
    constant is named like a weight."""
    value = _x(2, 3)
    datas = []
    for pkg in (mx, mxt):
        c = pkg.gluon.Constant("const_weight", value)
        c.initialize(ctx=pkg.cpu())
        assert c.grad_req == "null" and c.shape == (2, 3)
        datas.append(c.data().asnumpy())
    np.testing.assert_array_equal(datas[1], datas[0])


def test_split_and_load():
    x = _x(4, 3)
    got = mxt.gluon.split_and_load(x, [CPU])
    want = mx.gluon.split_and_load(x, [mx.cpu()])
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].asnumpy(), want[0].asnumpy())
