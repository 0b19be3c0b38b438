"""The ResNet training slice on the CPU, against the JAX package.

A small NHWC ResNet v1 (``ResNetV1(BottleneckV1, [1, 1, 1, 1],
[16, 128, 256, 384, 512], classes=10)`` at 2x64x64x3: every stage's
channels change, so stages 2-4 open with a downsample, and their three
body ``conv1``s and three downsample convs are stride-2 1x1 convs over
128, 256 and 384 channels, the six sites that ``MXNET_CONV1X1_PALLAS``
routes to K5) is built in both packages from the same seeded weights:

- the traced symbols list the same arguments and auxiliary states, with
  the same inferred shapes;
- the eager Gluon forwards agree;
- two SGD-momentum ``Module._step``s with the gate on (K5's plain version
  here, the Pallas kernel in interpret mode on the JAX side) agree in
  outputs, parameters and moving statistics, with both executors' conv
  bias -> BatchNorm and relu -> max-pool folds on.

The JAX package runs with ``MXNET_XLA_STATS=0`` (see
`test_torch_module.py`). Tolerances: f32 both sides, only summation order
differs. Forward outputs 1e-5 absolute on probabilities; after two steps
parameters and moving statistics 1e-4 relative and absolute. The steps
use lr 0.005 (momentum 0.9), not the benchmark's 0.05: a ReLU net's
gradient jumps where an activation crosses zero, and a larger step
carries the two packages' summation-order differences into more
activations near a kink and into a larger second-step drift. These
inputs put no activation so near zero that the two packages' rounding
flips it; a seed that did would fail this test without a fault.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops.conv_kernel import conv1x1_s2_dgrad
from mxnet_tpu_torch.ops.nn import _conv1x1_pallas_wanted

SPEC = ([1, 1, 1, 1], [16, 128, 256, 384, 512])
SHAPE = (2, 64, 64, 3)
OPT = {"learning_rate": 0.005, "momentum": 0.9}
OUT_TOL, TOL = 1e-5, 1e-4


def _weights(sym):
    """Seeded weights at sane scales (He-normal convs, gamma near 1) and
    moving statistics, by name."""
    shapes, _, aux_shapes = sym.infer_shape(data=SHAPE)
    rng = np.random.RandomState(0)
    arg, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("weight"):
            arg[name] = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("gamma"):
            arg[name] = rng.uniform(0.5, 1.5, shape)
        else:
            arg[name] = rng.randn(*shape) * 0.1
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = rng.randn(*shape) * 0.1 if name.endswith("mean") \
            else rng.uniform(0.5, 2.0, shape)
    return ({k: v.astype(np.float32) for k, v in arg.items()},
            {k: v.astype(np.float32) for k, v in aux.items()})


@pytest.fixture(scope="module")
def nets():
    """Both packages' small ResNets, eagerly materialised and traced, with
    the same weights; the gate on and plain jit for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_XLA_STATS", "0")
        mp.setenv("MXNET_CONV1X1_PALLAS", "1")
        jnet = jresnet.ResNetV1(jresnet.BottleneckV1, *SPEC, classes=10,
                                layout="NHWC", prefix="net_")
        jnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
        jnet(mx.nd.zeros(SHAPE))
        tnet = tvision.ResNetV1(tvision.BottleneckV1, *SPEC, classes=10,
                                layout="NHWC", prefix="net_")
        tnet.initialize(mxt.init.Xavier(), ctx=mxt.cpu())
        tnet(mxt.nd.zeros(SHAPE, ctx=mxt.cpu()))
        jsym = mx.sym.SoftmaxOutput(jnet._trace_symbol(), name="softmax")
        tsym = mxt.sym.SoftmaxOutput(tnet._trace_symbol(), name="softmax")
        arg, aux = _weights(tsym)
        gluon = dict(arg, **{k.replace("moving_", "running_"): v
                             for k, v in aux.items()})
        for name, param in jnet.collect_params().items():
            param.set_data(mx.nd.array(gluon[name]))
        mxt.set_block_params(tnet, gluon)
        yield {"jnet": jnet, "tnet": tnet, "jsym": jsym, "tsym": tsym,
               "arg": arg, "aux": aux}


def test_traced_symbols_match(nets):
    jsym, tsym = nets["jsym"], nets["tsym"]
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert len(tsym.list_auxiliary_states()) == 2 * 17   # 17 BatchNorms
    assert tsym.list_outputs() == jsym.list_outputs() == ["softmax_output"]
    got, want = tsym.infer_shape(data=SHAPE), jsym.infer_shape(data=SHAPE)
    for g, w in zip(got, want):
        assert [tuple(s) for s in g] == [tuple(s) for s in w]


def test_eager_forward_matches(nets):
    x = np.random.RandomState(1).rand(*SHAPE).astype(np.float32)
    want = nets["jnet"](mx.nd.array(x)).asnumpy()
    got = nets["tnet"](mxt.nd.array(x, ctx=mxt.cpu())).asnumpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _module(pkg, sym, arg, aux):
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(data_shapes=[("data", SHAPE)],
             label_shapes=[("softmax_label", (SHAPE[0],))])
    mod.init_params(initializer=pkg.init.Xavier(),
                    arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
                    aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return mod


def test_two_module_steps_match(nets):
    jmod = _module(mx, nets["jsym"], nets["arg"], nets["aux"])
    tmod = _module(mxt, nets["tsym"], nets["arg"], nets["aux"])
    rng = np.random.RandomState(2)
    k5 = []
    for _ in range(2):
        data = rng.rand(*SHAPE).astype(np.float32)
        label = rng.randint(0, 10, SHAPE[0]).astype(np.float32)
        jmod._step(mx.io.DataBatch(data=[mx.nd.array(data)],
                                   label=[mx.nd.array(label)]))
        before = conv1x1_s2_dgrad.launches
        tmod._step(mxt.io.DataBatch(data=[mxt.nd.array(data)],
                                    label=[mxt.nd.array(label)]))
        k5.append(conv1x1_s2_dgrad.launches - before)
        got, want = (m.get_outputs()[0].asnumpy() for m in (tmod, jmod))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=OUT_TOL)
    assert k5 == [0, 0]      # CPU tensors take the plain version
    for got, want in zip(tmod.get_params(), jmod.get_params()):
        got, want = mxt.params_to_numpy(got), mxt.params_to_numpy(want)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=TOL,
                                       atol=TOL, err_msg=name)
    moved = [n for n, v in mxt.params_to_numpy(tmod.get_params()[1]).items()
             if not np.allclose(v, nets["aux"][n])]
    assert len(moved) == len(nets["aux"])    # training updated every stat


def test_resnet50_v1_nhwc_structure():
    """The benchmark's net: the same parameters and auxiliary states in
    both packages, and exactly six convolutions that the gate sends to
    K5 at 224x224."""
    jnet = jresnet.get_resnet(1, 50, classes=1000, layout="NHWC",
                              prefix="r50_")
    tnet = tvision.get_model("resnet50_v1", classes=1000, layout="NHWC",
                             prefix="r50_")
    jparams, tparams = jnet.collect_params(), tnet.collect_params()
    assert list(tparams.keys()) == list(jparams.keys())
    assert [p.shape for p in tparams.values()] == \
        [p.shape for p in jparams.values()]
    tsym = tnet._trace_symbol()
    assert tsym.list_arguments() == jnet._trace_symbol().list_arguments()
    shapes = dict(zip(tsym.list_arguments(),
                      tsym.infer_shape(data=(1, 224, 224, 3))[0]))
    assert sum(int(np.prod(s)) for n, s in shapes.items() if n != "data") \
        == 25_557_032 + 18_880   # ResNet-50, plus the bottleneck conv biases
    gated = []
    internals = tsym.get_internals()
    for node in tsym._topo_nodes():
        if node.op != "Convolution":
            continue
        src, oi = node.inputs[0]
        dshape = internals[
            "%s_output" % src.name].infer_shape(data=(1, 224, 224, 3))[1][0] \
            if not src.is_var() else (1, 224, 224, 3)
        a = node.attrs
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MXNET_CONV1X1_PALLAS", "1")
            if _conv1x1_pallas_wanted(tuple(a["kernel"]), tuple(a["stride"]),
                                      tuple(a["pad"]), tuple(a["dilate"]),
                                      a["num_group"], True, 2, dshape):
                gated.append((node.name, dshape[-1]))
    assert [c for _, c in gated] == [256, 256, 512, 512, 1024, 1024]


def test_gluon_parameters_defer_and_place():
    net = tvision.get_model("resnet18_v1", classes=4, layout="NHWC",
                            prefix="r18_")
    params = net.collect_params()
    assert params["r18_conv0_weight"].shape == (64, 7, 7, 0)
    with pytest.raises(mxt.MXNetError, match="CUDA device"):
        net.initialize()                     # gpu(0) by default
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu())
    with pytest.raises(mxt.gluon.DeferredInitializationError):
        params["r18_conv0_weight"].data()
    out = net(mxt.nd.zeros((1, 32, 32, 3), ctx=mxt.cpu()))
    assert out.shape == (1, 4)
    assert params["r18_conv0_weight"].shape == (64, 7, 7, 3)
    with pytest.raises(mxt.MXNetError, match="pretrained"):
        tvision.get_model("resnet50_v1", pretrained=True)
