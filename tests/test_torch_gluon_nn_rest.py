"""The rest of ``gluon.nn`` and the live ``gluon.loss.CTCLoss`` on the port,
against the JAX package, on the CPU.

The fourteen layers the port lacked (``InstanceNorm``, ``PReLU``, ``ELU``,
``SELU``, ``Swish``, ``Conv3D``, ``Conv1DTranspose``, ``Conv2DTranspose``,
``Conv3DTranspose``, ``MaxPool3D``, ``AvgPool3D``, ``GlobalMaxPool3D``,
``GlobalAvgPool3D``, ``ReflectionPad2D``) run in a few stacks built in
both packages under one prefix, deferred shapes read from the data: the
JAX stack's initial weights are copied into the port's by name, and the
forward output, the input gradient and every parameter gradient of
``sum(out * r + out ** 2)`` (``r`` fixed draws) are held, eager and
hybridized, f32 both sides: outputs at rtol 1e-5, atol 1e-6, gradients
at rtol 1e-4, atol 1e-5 (the reference's `tests/test_pallas.py`
gradient tolerance; InstanceNorm's backward cancels, and its small
elements move by a few 1e-6 with the order of the sums).
``gluon.loss.CTCLoss`` is held the same way over its layouts, lengths
and sample weights. The modules' ``__all__`` equal the JAX ones.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _no_xla_stats(monkeypatch):
    monkeypatch.setenv("MXNET_XLA_STATS", "0")


def test_all_equals_the_jax_packages():
    from mxnet_tpu.gluon.nn import basic_layers as jb, conv_layers as jc
    from mxnet_tpu_torch.gluon.nn import basic_layers as tb, conv_layers as tc
    assert tb.__all__ == jb.__all__
    assert tc.__all__ == jc.__all__
    assert mxt.gluon.loss.__all__ == mx.gluon.loss.__all__
    for name in jb.__all__ + jc.__all__:
        assert hasattr(mxt.gluon.nn, name), name


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(build, x):
    """``build(pkg)`` in both packages, initialised on the CPU, one eager
    forward to finish deferred shapes, the port's weights set to the JAX
    net's."""
    nets = []
    for pkg in (mx, mxt):
        with pkg.cpu():
            net = build(pkg)
            net.initialize(pkg.init.Xavier())
            net(pkg.nd.array(x, ctx=pkg.cpu()))
        nets.append(net)
    jp, tp = nets[0].collect_params(), nets[1].collect_params()
    assert sorted(jp.keys()) == sorted(tp.keys())
    for name in jp.keys():
        assert jp[name].shape == tp[name].shape, name
        tp[name].set_data(mxt.nd.array(jp[name].data().asnumpy(), ctx=CPU))
    return nets


def _run(net, pkg, x, hybridize):
    if hybridize:
        net.hybridize()
    a = pkg.nd.array(x, ctx=pkg.cpu())
    a.attach_grad()
    with pkg.autograd.record():
        out = net(a)
        r = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
        loss = (out * pkg.nd.array(r, ctx=pkg.cpu()) + out * out).sum()
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in
             sorted(net.collect_params().items()) if p.grad_req != "null"}
    return out.asnumpy(), a.grad.asnumpy(), grads


def _alpha(desc, arr):
    """PReLU's slope: in both packages a name ending in ``alpha`` is no
    pattern of the initializers' name dispatch, so it takes a callable."""
    arr[:] = 0.3


def _stack(*layers):
    def build(pkg):
        net = pkg.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(*[make(pkg.gluon.nn) for make in layers])
        return net
    return build


STACKS = {
    "conv3d_pools_transpose": (_stack(
        lambda nn: nn.Conv3D(4, 3, padding=1),
        lambda nn: nn.MaxPool3D(2),
        lambda nn: nn.Conv3DTranspose(3, 2, strides=2, output_padding=0),
        lambda nn: nn.AvgPool3D(2, strides=1, padding=1,
                                count_include_pad=False),
        lambda nn: nn.GlobalAvgPool3D()), (2, 2, 4, 6, 4)),
    "conv3d_global_max": (_stack(
        lambda nn: nn.Conv3D(3, (1, 2, 3), strides=(1, 2, 1)),
        lambda nn: nn.GlobalMaxPool3D()), (2, 2, 3, 5, 4)),
    "conv1d_transpose_activations": (_stack(
        lambda nn: nn.Conv1DTranspose(6, 3, strides=2, padding=1,
                                      output_padding=1, groups=2),
        lambda nn: nn.ELU(alpha=0.7),
        lambda nn: nn.Swish(beta=1.5),
        lambda nn: nn.SELU()), (2, 4, 7)),
    "conv2d_transpose_norm_prelu_pad": (_stack(
        lambda nn: nn.Conv2DTranspose(6, 4, strides=2, padding=1,
                                      activation="relu"),
        lambda nn: nn.InstanceNorm(scale=True),
        lambda nn: nn.PReLU(alpha_initializer=_alpha),
        lambda nn: nn.ReflectionPad2D(1),
        lambda nn: nn.Conv2D(3, 3)), (2, 3, 5, 4)),
    "conv2d_transpose_dilated_no_bias": (_stack(
        lambda nn: nn.Conv2DTranspose(4, (3, 2), strides=(1, 2),
                                      dilation=(2, 1), use_bias=False,
                                      in_channels=3)), (1, 3, 4, 4)),
    "instance_norm_channel_last": (_stack(
        lambda nn: nn.InstanceNorm(axis=2, center=False, scale=True,
                                   epsilon=1e-3)), (3, 6, 5)),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("key", sorted(STACKS))
def test_layers_match_jax(key, hybridize):
    build, shape = STACKS[key]
    x = _x(*shape)
    nets = _pair(build, x)
    want = _run(nets[0], mx, x, hybridize)
    got = _run(nets[1], mxt, x, hybridize)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert sorted(got[2]) == sorted(want[2])
    for name in want[2]:
        np.testing.assert_allclose(got[2][name], want[2][name],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_transposed_weights_are_in_out_over_groups_k():
    for pkg in (mx, mxt):
        layer = pkg.gluon.nn.Conv2DTranspose(6, (3, 2), groups=3,
                                             in_channels=9)
        assert layer.weight.shape == (9, 2, 3, 2)
        layer = pkg.gluon.nn.Conv1DTranspose(4, 5)
        layer.initialize(ctx=pkg.cpu())
        layer(pkg.nd.array(_x(1, 7, 6), ctx=pkg.cpu()))
        assert layer.weight.shape == (7, 4, 5)


@pytest.mark.parametrize("cls", ["Conv1DTranspose", "Conv2DTranspose",
                                 "Conv3DTranspose"])
def test_channel_last_transposed_conv_raises_in_both(cls):
    layout = {"Conv1DTranspose": "NWC", "Conv2DTranspose": "NHWC",
              "Conv3DTranspose": "NDHWC"}[cls]
    for pkg in (mx, mxt):
        with pytest.raises(ValueError, match="channel-last"):
            getattr(pkg.gluon.nn, cls)(4, 3, layout=layout)


def _ctc_inputs(layout, label_layout, seed=2):
    rng = np.random.RandomState(seed)
    T, B, C = 9, 3, 5
    pred = rng.randn(B, T, C).astype(np.float32)
    label = np.full((B, 4), -1.0, np.float32)
    for b, n in enumerate((4, 2, 3)):
        label[b, :n] = rng.randint(0, C - 1, n)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    return pred, label


CTC_CASES = [("NTC", "NT", False, False, False),
             ("TNC", "NT", False, False, False),
             ("NTC", "TN", False, False, False),
             ("TNC", "TN", True, True, False),
             ("NTC", "NT", True, False, True),
             ("NTC", "NT", False, True, True)]


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("layout,label_layout,plen,llen,weighted",
                         CTC_CASES)
def test_gluon_ctc_loss_matches_jax(layout, label_layout, plen, llen,
                                    weighted, hybridize):
    pred, label = _ctc_inputs(layout, label_layout)
    extra = [np.array([9, 7, 8], np.float32) if plen else None,
             np.array([4, 2, 3], np.float32) if llen else None,
             np.array([1.0, 0.5, 2.0], np.float32) if weighted
             else None]
    res = []
    for pkg in (mx, mxt):
        loss_fn = pkg.gluon.loss.CTCLoss(layout=layout,
                                         label_layout=label_layout,
                                         weight=0.5)
        if hybridize:
            loss_fn.hybridize()
        p = pkg.nd.array(pred, ctx=pkg.cpu())
        p.attach_grad()
        args = [None if e is None else pkg.nd.array(e, ctx=pkg.cpu())
                for e in extra]
        with pkg.autograd.record():
            out = loss_fn(p, pkg.nd.array(label, ctx=pkg.cpu()), *args)
        out.backward()
        res.append((out.asnumpy(), p.grad.asnumpy()))
    (wo, wg), (go, gg) = res
    assert go.shape == wo.shape == (3,)
    np.testing.assert_allclose(go, wo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gg, wg, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_a_hybridized_block_that_draws_runs_uncaptured_and_draws_anew():
    """A replay would repeat the draws of a capture: the program is
    counted once as uncaptured (on the CPU its first run counts it, as
    the card's warm-up does) and every call draws anew."""
    from mxnet_tpu_torch import compiled

    class Noisy(mxt.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x + F.random.uniform(0, 1, shape=(1,), ctx=x.context)

    net = Noisy()
    net.hybridize()
    x = mxt.nd.zeros((2,), ctx=CPU)
    before = compiled.compile_counts()
    a, b = net(x).asnumpy(), net(x).asnumpy()
    after = compiled.compile_counts()
    assert after["uncaptured"] == before["uncaptured"] + 1
    assert a[0] != b[0]


def test_gluon_ctc_loss_refuses_other_layouts():
    for pkg in (mx, mxt):
        with pytest.raises((ValueError, AssertionError)):
            pkg.gluon.loss.CTCLoss(layout="NCT")
        with pytest.raises((ValueError, AssertionError)):
            pkg.gluon.loss.CTCLoss(label_layout="TNC")


def test_weights_cross_by_name_into_a_deferred_port_net():
    """`weights.py` carries the new layers' parameters as they are: a JAX
    stack's weights set into a port stack whose shapes are still
    deferred give the JAX forward."""
    from mxnet_tpu_torch.weights import params_to_numpy, set_block_params
    build, shape = STACKS["conv2d_transpose_norm_prelu_pad"]
    x = _x(*shape)
    with mx.cpu():
        jnet = build(mx)
        jnet.initialize(mx.init.Xavier())
        want = jnet(mx.nd.array(x)).asnumpy()
    arrays = params_to_numpy({k: v.data() for k, v in
                              jnet.collect_params().items()})
    with mxt.cpu():
        tnet = build(mxt)
        tnet.initialize(mxt.init.Xavier())
        set_block_params(tnet, arrays)
        got = tnet(mxt.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
